"""Offline GST predictor training (JAX package ``models/gst/trainer.py:1-413``;
reference gst_updated/scripts/experiments/train.py:17-195).

Padded fixed-shape batches, Adam under the reference's StepLR (x0.3 every
``temp_epochs / 4`` epochs, applied per step as optax's
``piecewise_constant_schedule``), linear Gumbel temperature annealing to
0.03, the NLL or the deterministic offset loss, aoe/foe validation metrics,
and checkpoints with the optimizer state so that a resumed run reproduces
the one that never stopped. The model runs without dropout, as the JAX
package's does (its ``loss_fn`` applies the model with ``deterministic``
left at True, :97-98).

The JAX package's "fused epochs" become epochs over windows resident on the
device, batches gathered there by index; ``--host-batches`` copies each
batch from the host instead. Both run the same update sequence: the shuffle
is the JAX package's ``np.random.RandomState(seed + epoch)`` permutation,
so the batch order is the JAX package's too.

Usage (``--edge-heads 4 --ghost`` trains the sparse GST, whose edge
selector may pick no neighbour):
  python -m crowdnav_prediction_attngraph_tpu_torch.models.gst.trainer \\
      --data-dir data/orca_20humans --epochs 100 --out results/gst_run

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...config import PredConfig
from ...utils import checkpoint as ckpt_util
from ...utils.device import resolve_device
from . import dataset as ds
from .losses import negative_log_likelihood, offset_error_square, offset_errors
from .predictor import load_gst
from .st_model import STModel, init_gst

HIST_KEYS = ("train_loss", "val_loss", "train_aoe", "val_aoe", "train_foe",
             "val_foe")


def temperature(epoch: int, temp_epochs: int, init_temp: float,
                temp_min: float = 0.03) -> float:
    """Linear annealing (temperature_scheduler.py:12-20)."""
    t = (1.0 - epoch / temp_epochs) * (init_temp - temp_min) + temp_min
    return max(t, temp_min)


def lr_schedule(lr: float, temp_epochs: int, steps_per_epoch: int):
    """step -> learning rate: ``lr`` scaled by 0.3 at each of the steps
    ``k * max(temp_epochs // 4, 1) * steps_per_epoch``, k = 1..4, from that
    step on (JAX ``make_optimizer``, :43-56). Step i is the (i + 1)-th Adam
    step, as optax counts; the value is computed in f32 as optax computes
    it."""
    step_size = max(int(temp_epochs / 4), 1) * steps_per_epoch
    boundaries = [k * step_size for k in range(1, 5)]
    scale = np.float32(0.3)

    def at(step: int) -> float:
        v = np.float32(lr)
        for b in boundaries:
            ind = np.float32(step < b)
            v = v * ind + (np.float32(1.0) - ind) * scale * v
        return float(v)
    return at


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax ``scale_by_adam``'s defaults (b1 0.9, b2 0.999,
    eps 1e-8); the schedule sets each step's lr."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def rotate_graph(v, A, theta):
    """Rotate node displacements and pairwise edges by per-window angles
    (reference mgnn/utils.py:66-84 ``rotate_graph``).
    v (B, seq, P, 2), A (B, seq, P, P, 2), theta (B,) radians."""
    def rot(x):
        shape = (x.shape[0],) + (1,) * (x.dim() - 2)
        c = torch.cos(theta).reshape(shape)
        s = torch.sin(theta).reshape(shape)
        return torch.stack([x[..., 0] * c - x[..., 1] * s,
                            x[..., 0] * s + x[..., 1] * c], dim=-1)
    return rot(v), rot(A)


def random_rotate_batch(batch: Dict[str, torch.Tensor],
                        generator: torch.Generator, pattern: str):
    """Random-rotation augmentation (reference mgnn/utils.py:86-98), one
    angle per window drawn from ``generator``: uniform on [0, 2 pi)
    (``random``) or a multiple of pi / 2 (``right_angle``). Masks are
    rotation-invariant and left untouched."""
    v = batch["v"]
    B = v.shape[0]
    if pattern == "right_angle":
        theta = torch.randint(0, 4, (B,), generator=generator,
                              device=v.device).float() * (math.pi / 2.0)
    elif pattern == "random":
        theta = torch.rand(B, generator=generator,
                           device=v.device) * (2.0 * math.pi)
    else:
        raise ValueError(f"unknown rotation pattern {pattern!r}")
    v, A = rotate_graph(v, batch["A"], theta)
    return dict(batch, v=v, A=A)


def forward_batch(model: STModel, batch, tau: float, hard: bool,
                  sampling: bool, deterministic_loss: bool,
                  generator: Optional[torch.Generator] = None):
    """One forward pass over a window batch: (loss, per-ped aoe (B, P),
    per-ped foe (B, P), full-period mask (B, P)); the metrics carry no
    gradient (JAX ``loss_fn`` :89-113 and ``eval._forward``)."""
    obs = model.cfg.obs_seq_len
    lm_rel = batch["loss_mask_rel"]
    v_pred_gt = batch["v"][:, obs:]
    gp, x_sample = model(batch["v"][:, :obs], batch["attn_mask"][:, :obs],
                         lm_rel, batch["A"][:, :obs], tau, hard, sampling,
                         generator)
    lm_fp = lm_rel[:, :, obs - 1]
    lm_pred = lm_rel[:, :, obs:]
    if deterministic_loss:
        err, mask = offset_error_square(x_sample, v_pred_gt, lm_fp, lm_pred)
    else:
        err, mask = negative_log_likelihood(gp, v_pred_gt, lm_fp, lm_pred)
    loss = err.sum() / mask.sum().clamp_min(1.0)
    with torch.no_grad():
        # metrics over fully-observed pedestrians (mgnn/utils.py:8-26)
        full = (lm_rel.sum(dim=2) == lm_rel.shape[2]).float()
        aoe, foe = offset_errors(x_sample, v_pred_gt, full)
    return loss, aoe, foe, full


def loss_fn(model: STModel, batch, tau: float, deterministic_loss: bool,
            generator: Optional[torch.Generator] = None):
    """Training loss (soft edges, mean feedback) and the metrics as
    (aoe sum, foe sum, full-period count), which the epoch loop normalises
    over the whole epoch as the reference does (gst train.py:149-156)."""
    loss, aoe, foe, full = forward_batch(model, batch, tau, False, False,
                                         deterministic_loss, generator)
    return loss, torch.stack([aoe.sum(), foe.sum(), full.sum()])


def train_step(model: STModel, optimizer: torch.optim.Adam, lr: float,
               batch, tau: float, generator: torch.Generator,
               deterministic_loss: bool, rotation_pattern: Optional[str]):
    """One Adam step at learning rate ``lr`` (JAX ``_step_math``); returns
    (loss, metric sums), both detached, on the device."""
    if rotation_pattern is not None:
        batch = random_rotate_batch(batch, generator, rotation_pattern)
    loss, aux = loss_fn(model, batch, tau, deterministic_loss, generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return loss.detach(), aux


def stack_windows(windows) -> Dict[str, np.ndarray]:
    """One contiguous (N, ...) array per window field."""
    return {k: np.stack([w[k] for w in windows]) for k in windows[0]}


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of stacked numpy windows as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in batch.items()}


def _generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (the run's seed, the
    epoch, the stream), so each epoch's draws are the same whether the run
    started at epoch 1 or resumed."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1,
                                                                  np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resident_fits(train_windows, val_windows) -> bool:
    """The device-resident epochs put every stacked window on the card; an
    uncapped collected stream (millions of ~100 KB windows) would not fit.
    Above ``GST_FUSED_HBM_BUDGET`` bytes (8 GiB by default) the run takes
    the host-batch path instead (JAX :227-243)."""
    sample = train_windows[:1] + val_windows[:1]
    est_bytes = sum(sum(a.nbytes for a in w.values()) for w in sample) // max(
        len(sample), 1) * (len(train_windows) + len(val_windows))
    budget = int(os.environ.get("GST_FUSED_HBM_BUDGET", str(8 * 1024 ** 3)))
    if est_bytes > budget:
        print(f"[trainer] fused_epochs disabled: stacked windows ~"
              f"{est_bytes / 1e9:.1f} GB exceed the {budget / 1e9:.0f} GB "
              "device budget — falling back to host batches "
              "(cap the load with --max-windows to re-enable)")
        return False
    return True


def _val_batches(val_windows, val_data, batch_size: int, device):
    """The validation batches in order, the last one short (JAX
    ``ds.batches(..., shuffle=False, drop_last=False)``)."""
    n = len(val_windows)
    for s in range(0, n, batch_size):
        if val_data is not None:
            yield {k: a[s:s + batch_size] for k, a in val_data.items()}
        else:
            yield to_device(stack_windows(val_windows[s:s + batch_size]),
                             device)


def train(cfg: PredConfig, train_windows, val_windows, out_dir: str,
          epochs: int = 100, temp_epochs: int = 100, lr: float = 1e-3,
          batch_size: int = 16, init_temp: float = 0.5, seed: int = 1000,
          deterministic_loss: bool = False, save_epochs: int = 10,
          rotation_pattern: Optional[str] = None, resume_epoch: int = 0,
          host_batches: bool = False, params=None, device="cuda"):
    """Epoch loop (gst train.py:50-195; JAX :209-359). ``params`` (a
    flax-style tree or a ``.npz`` path) replaces the fresh init drawn from
    ``seed``. Returns (model, history): the history holds the JAX package's
    per-epoch ``train/val_loss/aoe/foe`` lists plus ``train_seconds``, each
    epoch's training time on the device's clock."""
    device = resolve_device(device)
    model = (load_gst(cfg, params, device) if params is not None
             else init_gst(cfg, torch.Generator().manual_seed(seed), device))
    model.train()
    steps_per_epoch = max(len(train_windows) // batch_size, 1)
    optimizer = make_optimizer(model, lr)
    lr_at = lr_schedule(lr, temp_epochs, steps_per_epoch)
    resident = not host_batches and _resident_fits(train_windows, val_windows)
    train_data = val_data = None
    if resident:
        train_data = to_device(stack_windows(train_windows), device)
        val_data = to_device(stack_windows(val_windows), device)

    os.makedirs(out_dir, exist_ok=True)
    # tfevents matching the reference's tensorboardX scalars (gst
    # train.py:192-194); the JSON history stays the primary record
    writer = None
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(os.path.join(out_dir, "tensorboard"))
    except (ImportError, OSError) as e:
        print(f"[trainer] tfevents disabled ({type(e).__name__}: {e})")
    hist = {k: [] for k in HIST_KEYS + ("train_seconds",)}
    step = 0
    if resume_epoch:
        step = ckpt_util.restore_trainer_checkpoint(
            os.path.join(out_dir, f"epoch_{resume_epoch}"), model, optimizer)
        hist_path = os.path.join(out_dir, "train_hist.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                saved = json.load(f)
            hist = {k: saved.get(k, [])[:resume_epoch] for k in hist}
    for epoch in range(resume_epoch + 1, epochs + 1):
        tau = temperature(epoch, temp_epochs, init_temp)
        t0 = time.time()
        rng = np.random.RandomState(seed + epoch)
        gen = _generator(device, seed, epoch, 0)
        if resident:
            perm = np.arange(len(train_windows))
            rng.shuffle(perm)
            n_steps = len(perm) // batch_size
            idx = torch.from_numpy(perm[:n_steps * batch_size]).to(
                device).reshape(n_steps, batch_size)
            batches = ({k: a.index_select(0, idx[i])
                        for k, a in train_data.items()}
                       for i in range(n_steps))
        else:
            batches = (to_device(b, device)
                       for b in ds.batches(train_windows, batch_size, rng))
        tl, t_aux = [], []
        _sync(device)
        t_train = time.perf_counter()
        for batch in batches:
            loss, aux = train_step(model, optimizer, lr_at(step), batch, tau,
                                   gen, deterministic_loss, rotation_pattern)
            step += 1
            tl.append(loss)
            t_aux.append(aux)
        _sync(device)
        hist["train_seconds"].append(time.perf_counter() - t_train)

        vgen = _generator(device, seed, epoch, 1)
        vl, v_aux = [], []
        with torch.no_grad():
            for batch in _val_batches(val_windows, val_data, batch_size,
                                      device):
                loss, aux = loss_fn(model, batch, tau, deterministic_loss,
                                    vgen)
                vl.append(loss)
                v_aux.append(aux)
        t_sums = torch.stack(t_aux).sum(0).tolist() if t_aux else [0.0] * 3
        v_sums = torch.stack(v_aux).sum(0).tolist() if v_aux else [0.0] * 3
        # epoch normalisation: sum over peds / sum of the full-period mask,
        # exactly the reference's (gst train.py:149-156, eval.py:139-147)
        td, vd = max(t_sums[2], 1.0), max(v_sums[2], 1.0)
        for name, val in (
                ("train_loss", torch.stack(tl).mean().item() if tl else np.nan),
                ("val_loss", torch.stack(vl).mean().item() if vl else np.nan),
                ("train_aoe", t_sums[0] / td), ("val_aoe", v_sums[0] / vd),
                ("train_foe", t_sums[1] / td), ("val_foe", v_sums[1] / vd)):
            hist[name].append(float(val))
        if writer is not None:
            for tag in ("loss", "aoe", "foe"):
                writer.add_scalars(tag, {
                    "train": hist[f"train_{tag}"][-1],
                    "val": hist[f"val_{tag}"][-1]}, epoch)
        print(f"Epoch {epoch} | train loss {hist['train_loss'][-1]:.4f} | "
              f"val loss {hist['val_loss'][-1]:.4f} | "
              f"train aoe {hist['train_aoe'][-1]:.4f} | "
              f"val aoe {hist['val_aoe'][-1]:.4f} | "
              f"tau {tau:.3f} | {time.time()-t0:.1f}s", flush=True)
        if epoch % save_epochs == 0 or epoch == epochs:
            ck_dir = os.path.join(out_dir, f"epoch_{epoch}")
            ckpt_util.save_trainer_checkpoint(ck_dir, model, optimizer, step)
            with open(os.path.join(out_dir, "train_hist.json"), "w") as f:
                json.dump(hist, f)
            # the stored val metrics feed eval.py's checkpoint-consistency
            # check (gst train.py:166-177 / eval.py:36-41)
            with open(os.path.join(ck_dir, "val_metrics.json"), "w") as f:
                json.dump({"val_loss_epoch": hist["val_loss"][-1],
                           "val_aoe_epoch": hist["val_aoe"][-1],
                           "val_foe_epoch": hist["val_foe"][-1],
                           "epoch": epoch}, f)
    if writer is not None:
        writer.close()
    return model, hist


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="results/gst_run")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--temp-epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-peds", type=int, default=32)
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--edge-heads", type=int, default=0,
                   help="edge-selector heads (0: full connectivity)")
    p.add_argument("--ghost", action="store_true",
                   help="the edge selector's ghost node (needs "
                        "--edge-heads)")
    p.add_argument("--rotation-pattern", default=None,
                   choices=["random", "right_angle"],
                   help="random-rotation augmentation "
                        "(reference mgnn/utils.py:86-98)")
    p.add_argument("--resume-epoch", type=int, default=0,
                   help="resume from <out>/epoch_N (reference "
                        "--resume_training/--resume_epoch)")
    p.add_argument("--stride", type=int, default=1,
                   help="window start stride (reference --skip)")
    p.add_argument("--max-windows", type=int, default=0,
                   help="cap the train window count (0 = all)")
    p.add_argument("--max-val-windows", type=int, default=0,
                   help="cap the val window count (0 = all)")
    p.add_argument("--host-batches", action="store_true",
                   help="copy each batch from the host instead of keeping "
                        "the windows resident on the device")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = dataclasses.replace(PredConfig(),
                              spatial_num_heads_edges=args.edge_heads,
                              ghost=args.ghost)
    train_w = ds.load_dataset(os.path.join(args.data_dir, "train"),
                              cfg.obs_seq_len, cfg.pred_seq_len,
                              args.max_peds, stride=args.stride,
                              max_windows=args.max_windows)
    test_dir = os.path.join(args.data_dir, "test")
    val_w = ds.load_dataset(test_dir, cfg.obs_seq_len, cfg.pred_seq_len,
                            args.max_peds, stride=args.stride,
                            max_windows=args.max_val_windows) \
        if os.path.isdir(test_dir) else train_w[: max(len(train_w) // 10, 1)]
    print(f"{len(train_w)} train windows, {len(val_w)} val windows")
    _, hist = train(cfg, train_w, val_w, args.out, epochs=args.epochs,
                    temp_epochs=args.temp_epochs, lr=args.lr,
                    batch_size=args.batch_size, seed=args.seed,
                    deterministic_loss=args.deterministic,
                    rotation_pattern=args.rotation_pattern,
                    resume_epoch=args.resume_epoch,
                    host_batches=args.host_batches, device=args.device)
    return hist


if __name__ == "__main__":
    main()
