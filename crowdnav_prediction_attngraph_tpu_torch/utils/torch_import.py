"""Import the reference's PyTorch checkpoints (JAX package
``utils/torch_import.py``).

Covers the RL policy (rl/networks/selfAttn_srnn_temp_node.py module layout)
and the GST predictor (gst_updated checkpoints, e.g. epoch_100.pt, with or
without the edge selector). Each mapping gives the flax-layout numpy tree
that ``utils/params.py`` turns into the port's modules (``load_policy``,
``load_gst``): torch ``Linear.weight`` (out, in) becomes a kernel (in, out);
the GRU/LSTM and packed attention matrices are transposed likewise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(w):  # torch Linear weight -> flax kernel
    return np.ascontiguousarray(np.asarray(w).T)


def _a(w):
    return np.asarray(w)


def policy_params_from_torch(state_dict: Dict[str, "object"]) -> Dict:
    """Map a reference ``Policy`` state_dict (model.py:14-42 with
    selfAttn_merge_SRNN base) onto models/policy.PolicyHead's tree."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": _t(sd[prefix + ".weight"]),
                "bias": _a(sd[prefix + ".bias"])}

    base = {}
    base["robot_linear"] = dense("base.robot_linear.0")
    base["spatial_linear"] = dense("base.spatial_linear.0")
    base["spatial_attn"] = {
        "embed_0": dense("base.spatial_attn.embedding_layer.0"),
        "embed_1": dense("base.spatial_attn.embedding_layer.2"),
        "q_linear": dense("base.spatial_attn.q_linear"),
        "k_linear": dense("base.spatial_attn.k_linear"),
        "v_linear": dense("base.spatial_attn.v_linear"),
        "mha_in_proj_weight": _t(sd["base.spatial_attn.multihead_attn.in_proj_weight"]),
        "mha_in_proj_bias": _a(sd["base.spatial_attn.multihead_attn.in_proj_bias"]),
        "mha_out_proj": dense("base.spatial_attn.multihead_attn.out_proj"),
    }
    base["attn"] = {
        "temporal_edge_layer": dense("base.attn.temporal_edge_layer.0"),
        "spatial_edge_layer": dense("base.attn.spatial_edge_layer.0"),
    }
    base["humanNodeRNN"] = {
        "encoder_linear": dense("base.humanNodeRNN.encoder_linear"),
        "edge_attention_embed": dense("base.humanNodeRNN.edge_attention_embed"),
        "output_linear": dense("base.humanNodeRNN.output_linear"),
        "gru": {
            "w_ih": _t(sd["base.humanNodeRNN.gru.weight_ih_l0"]),
            "w_hh": _t(sd["base.humanNodeRNN.gru.weight_hh_l0"]),
            "b_ih": _a(sd["base.humanNodeRNN.gru.bias_ih_l0"]),
            "b_hh": _a(sd["base.humanNodeRNN.gru.bias_hh_l0"]),
        },
    }
    base["actor_0"] = dense("base.actor.0")
    base["actor_1"] = dense("base.actor.2")
    base["critic_0"] = dense("base.critic.0")
    base["critic_1"] = dense("base.critic.2")
    base["critic_linear"] = dense("base.critic_linear")

    dist = {
        "fc_mean": dense("dist.fc_mean"),
        # AddBias stores (num_outputs, 1) (network_utils.py:28-36)
        "logstd": _a(sd["dist.logstd._bias"]).reshape(-1),
    }
    return {"params": {"base": base, "dist": dist}}


def gst_params_from_torch(state_dict: Dict[str, "object"],
                          num_layers: int = 1) -> Dict:
    """Map a GST st_model state_dict (epoch_100.pt['model_state_dict']) onto
    the STModel tree; the edge selector's keys are mapped when present."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": _t(sd[prefix + ".weight"]),
                "bias": _a(sd[prefix + ".bias"])}

    def layernorm(prefix):
        return {"scale": _a(sd[prefix + ".weight"]),
                "bias": _a(sd[prefix + ".bias"])}

    gst = {"node_embedding": dense("gumbel_social_transformer.node_embedding")}
    for i in range(num_layers):
        p = f"gumbel_social_transformer.node_encoder_layers.{i}"
        gst[f"layer_{i}"] = {
            "in_proj_weight": _t(sd[p + ".self_attn.in_proj_weight"]),
            "in_proj_bias": _a(sd[p + ".self_attn.in_proj_bias"]),
            "out_proj": dense(p + ".self_attn.out_proj"),
            "norm_node": layernorm(p + ".norm_node"),
            "norm1_node": layernorm(p + ".norm1_node"),
            "linear1": dense(p + ".linear1"),
            "linear2": dense(p + ".linear2"),
        }
    if "gumbel_social_transformer.edge_selector.augmented_edge_embedding.weight" in sd:
        p = "gumbel_social_transformer.edge_selector"
        gst["edge_selector"] = {
            "augmented_edge_embedding": dense(p + ".augmented_edge_embedding"),
            "norm_augmented_edge": layernorm(p + ".norm_augmented_edge"),
            "in_proj_weight": _t(sd[p + ".self_attn.in_proj_weight"]),
            "in_proj_bias": _a(sd[p + ".self_attn.in_proj_bias"]),
            "out_proj": dense(p + ".self_attn.out_proj"),
            "linear1": dense(p + ".linear1"),
            "linear2": dense(p + ".linear2"),
        }
    params = {
        "gst": gst,
        "lstm_w_ih": _t(sd["lstm.weight_ih_l0"]),
        "lstm_w_hh": _t(sd["lstm.weight_hh_l0"]),
        "lstm_b_ih": _a(sd["lstm.bias_ih_l0"]),
        "lstm_b_hh": _a(sd["lstm.bias_hh_l0"]),
        "hidden2pos": dense("hidden2pos"),
    }
    return {"params": params}


def load_torch_checkpoint(path: str) -> Dict:
    """The reference's checkpoint dict (tensors and numbers only; nothing
    else is unpickled)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_gst_checkpoint(path: str, num_layers: int = 1) -> Dict:
    """Load an st_model torch checkpoint file into a flax-layout tree."""
    ck = load_torch_checkpoint(path)
    sd = ck["model_state_dict"] if "model_state_dict" in ck else ck
    return gst_params_from_torch(sd, num_layers=num_layers)
