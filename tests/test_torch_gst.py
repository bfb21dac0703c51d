"""GST predictor: the PyTorch port against the JAX package on the committed
GST weights (results/gst_sj_tpu_r5_b64/epoch_100, exported to .npz).

Tolerances are those of tests/test_gst_parity.py:98,145 for the f32 path
(1e-4 for the model, 5e-4 for the absolute-frame wrapper, whose cumsums grow
the error). The bf16 matmul path rounds at the same points in both packages
but the two frameworks' bf16 products may round differently, so it is held
to a looser 2e-2.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.config import PredConfig as JPredConfig
from crowdnav_prediction_attngraph_tpu.models.gst.predictor import (
    gst_predict as j_gst_predict)
from crowdnav_prediction_attngraph_tpu.models.gst.st_model import (
    STModel as JSTModel)
from crowdnav_prediction_attngraph_tpu_torch.config import PredConfig
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import load_npz

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "crowdnav_prediction_attngraph_tpu_torch", "weights",
                       "gst_sj_tpu_r5_b64_epoch100.npz")


@pytest.fixture(scope="module")
def tree():
    return load_npz(WEIGHTS)


def make_history(rng, B, A, L):
    """Absolute positions with per-ped visibility gaps; one ped never seen."""
    start = rng.uniform(-5, 5, (B, A, 1, 2))
    steps = rng.uniform(-0.3, 0.3, (B, A, L, 2)).cumsum(axis=2)
    pos = (start + steps).astype(np.float32)
    mask = rng.uniform(size=(B, A, L)) > 0.2
    mask[:, -1] = False
    mask[:, 0] = True
    return pos, mask


def graph_inputs(pos, mask, K):
    """The wrapper's model inputs, built as gst_predict builds them."""
    m = mask.astype(np.float32)
    lm_obs = np.concatenate([m[..., :1], m[..., :-1] * m[..., -1:]], axis=-1)
    lm = np.concatenate([lm_obs, np.repeat(lm_obs[..., -1:], K, -1)], -1)
    lm_t = lm_obs.transpose(0, 2, 1)
    attn = lm_t[..., :, None] * lm_t[..., None, :]
    disp = np.diff(pos, axis=2, prepend=pos[:, :, :1])
    disp = np.where(lm_obs[..., None] > 0, disp, -999.0).astype(np.float32)
    return disp.transpose(0, 2, 1, 3), attn.astype(np.float32), lm


@pytest.mark.parametrize("matmul_dtype,atol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_st_model_matches_jax(tree, matmul_dtype, atol):
    B, A, L, K = 3, 7, 5, 5
    rng = np.random.RandomState(0)
    pos, mask = make_history(rng, B, A, L)
    v_obs, attn, lm = graph_inputs(pos, mask, K)
    A_obs = (pos.transpose(0, 2, 1, 3)[:, :, :, None]
             - pos.transpose(0, 2, 1, 3)[:, :, None]).astype(np.float32)

    jcfg = dataclasses.replace(JPredConfig(), matmul_dtype=matmul_dtype)
    (mu_j, sx_j, sy_j, corr_j), _ = JSTModel(jcfg).apply(
        tree, jnp.asarray(v_obs), jnp.asarray(A_obs),
        jnp.asarray(attn), jnp.asarray(lm), 0.03, True, False)

    model = load_gst(dataclasses.replace(PredConfig(),
                                         matmul_dtype=matmul_dtype), tree,
                     "cpu")
    with torch.no_grad():
        got, _ = model(torch.from_numpy(v_obs), torch.from_numpy(attn),
                       torch.from_numpy(lm))
    for name, g, e in zip(("mu", "sx", "sy", "corr"), got,
                          (mu_j, sx_j, sy_j, corr_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=atol,
                                   err_msg=name)


def test_predictor_wrapper_matches_jax(tree):
    B, A, L = 4, 6, 5
    rng = np.random.RandomState(1)
    pos, mask = make_history(rng, B, A, L)
    jcfg = JPredConfig()
    pred = jax.jit(jax.vmap(lambda t, m: j_gst_predict(jcfg, tree,
                                                       t, m)))
    out_j, mask_j = pred(jnp.asarray(pos), jnp.asarray(mask))

    model = load_gst(PredConfig(), tree, "cpu")
    out, out_mask = gst_predict(model, torch.from_numpy(pos),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=5e-4)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(mask_j))
    assert not out_mask[:, -1].any()   # never-observed ped is masked out
