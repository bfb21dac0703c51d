"""GST trajectory dataset: txt records -> padded graph windows.

The port's own copy of the JAX package's ``models/gst/dataset.py`` (numpy
only; the port imports nothing of the JAX package). It must give the same
windows, bit for bit, on the same files, so its code is that module's.

Replaces the reference's per-scene variable-size graph batches
(gst_updated/src/mgnn/trajectories*.py + batch_trajectories.py, batch_size
forced to 1) with fixed-size padded windows batched for the MXU. Input txt
format is the reference's own (frame\\tid\\tx\\ty, collect_data.py:72-76), so
eth/ucy/self-collected files work unchanged.

Each window: seq_len = obs_len + pred_len consecutive frames; pedestrians
appearing in >= 2 frames of the window occupy slots (padded to max_peds).
Outputs per window:
  v: (seq, P, 2) displacements (0 at first valid frame)
  A: (seq, P, P, 2) pairwise relative positions
  attn_mask: (seq, P, P) pairwise validity
  loss_mask: (P, seq) raw per-frame presence
  loss_mask_rel: (P, seq) displacement validity (present at t and t-1;
                 first appearance counts, mirroring the reference's
                 rel masks in crowd_nav_interface_parallel.py:77-78 shape)
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Iterator, List, Tuple

import numpy as np


def read_txt(path: str) -> np.ndarray:
    """(N, 4) rows of frame, ped_id, x, y."""
    return np.loadtxt(path, delimiter="\t").reshape(-1, 4)


def build_windows(records: np.ndarray, obs_len: int = 5, pred_len: int = 5,
                  max_peds: int = 32, stride: int = 1, max_windows: int = 0):
    """Yield padded windows from one env's record stream. Frame bucketing is
    one stable sort + split (a per-frame boolean mask is O(frames x records)
    — quadratic, hours on a million-record stream); ``max_windows`` stops
    early so capped loads don't pay for windows they discard."""
    seq_len = obs_len + pred_len
    order = np.argsort(records[:, 0], kind="stable")
    rec_sorted = records[order]
    frames, starts = np.unique(rec_sorted[:, 0], return_index=True)
    rows_by_frame = np.split(rec_sorted, starts[1:])
    by_frame = dict(zip(frames, rows_by_frame))
    windows = []
    for s in range(0, len(frames) - seq_len + 1, stride):
        if max_windows and len(windows) >= max_windows:
            break
        fr = frames[s:s + seq_len]
        # consecutive frames only
        if not np.allclose(np.diff(fr), fr[1] - fr[0]):
            continue
        rows = [by_frame[f] for f in fr]
        ped_ids = np.unique(np.concatenate([r[:, 1] for r in rows]))
        # keep pedestrians present in >=2 frames (displacements exist)
        keep = [p for p in ped_ids
                if sum(1 for r in rows if p in r[:, 1]) >= 2]
        if not keep or len(keep) > max_peds:
            continue
        P = max_peds
        pos = np.zeros((seq_len, P, 2), np.float32)
        present = np.zeros((seq_len, P), np.float32)
        for t, r in enumerate(rows):
            for j, p in enumerate(keep):
                hit = r[r[:, 1] == p]
                if len(hit):
                    pos[t, j] = hit[0, 2:4]
                    present[t, j] = 1.0
        windows.append(_window_arrays(pos, present, obs_len, pred_len))
    return windows


def _window_arrays(pos, present, obs_len, pred_len):
    seq_len, P, _ = pos.shape
    # displacement validity: valid at t if present at t and t-1 (or t == first)
    rel_valid = np.zeros_like(present)
    rel_valid[0] = present[0]
    rel_valid[1:] = present[1:] * present[:-1]
    v = np.zeros_like(pos)
    v[1:] = (pos[1:] - pos[:-1]) * rel_valid[1:, :, None]
    A = (pos[:, :, None, :] - pos[:, None, :, :]) * \
        (present[:, :, None, None] * present[:, None, :, None])
    attn = rel_valid[:, :, None] * rel_valid[:, None, :]
    return {
        "v": v.astype(np.float32),
        "A": A.astype(np.float32),
        "attn_mask": attn.astype(np.float32),
        "loss_mask": np.transpose(present, (1, 0)).astype(np.float32),
        "loss_mask_rel": np.transpose(rel_valid, (1, 0)).astype(np.float32),
    }


def load_dataset(data_dir: str, obs_len: int = 5, pred_len: int = 5,
                 max_peds: int = 32, stride: int = 1,
                 cache: bool = True, max_windows: int = 0) -> List[dict]:
    """Window building is pure-python per frame (~10 s per 20k records), so
    the stacked window arrays are cached beside the txt files; the cache key
    carries every windowing parameter (ADVICE r2: a cache built under one
    max_peds must not be reused under another). ``max_windows`` stops
    READING once reached — a collected stream can hold millions of windows
    (~80 KB each) and both the loader and the fused-epoch device copy must
    stay bounded."""
    # the cache must also be invalidated when the SOURCE txt files change —
    # data/sj is re-collected between rounds and a stale windows_*.npz in a
    # refreshed dir would silently train on the previous collection (ADVICE
    # r3). Fingerprint = hash of sorted (filename, size, mtime) of the txts.
    txts = sorted(n for n in os.listdir(data_dir) if n.endswith(".txt"))
    fp_src = "".join(
        f"{n}:{os.path.getsize(os.path.join(data_dir, n))}:"
        f"{int(os.path.getmtime(os.path.join(data_dir, n)))};" for n in txts)
    fingerprint = hashlib.sha1(fp_src.encode()).hexdigest()[:10]
    cache_path = os.path.join(
        data_dir, f"windows_o{obs_len}_p{pred_len}_m{max_peds}_s{stride}"
                  + (f"_w{max_windows}" if max_windows else "")
                  + f"_f{fingerprint}.npz")
    if cache and os.path.exists(cache_path):
        try:
            with np.load(cache_path) as z:
                # materialize each array ONCE — NpzFile re-decompresses the
                # whole array on EVERY key access, so indexing z[k][i] in a
                # loop is O(n^2) decompression
                arrays = {k: z[k] for k in z.files}
            n = arrays["v"].shape[0]
            return [{k: a[i] for k, a in arrays.items()} for i in range(n)]
        except (zipfile.BadZipFile, KeyError, ValueError, OSError, EOFError):
            # truncated cache from an interrupted run (container resets are a
            # known hazard here): drop it and rebuild (ADVICE r3)
            try:
                os.remove(cache_path)
            except OSError:
                pass
    windows = []
    for name in txts:
        rec = read_txt(os.path.join(data_dir, name))
        room = max_windows - len(windows) if max_windows else 0
        windows.extend(build_windows(rec, obs_len, pred_len, max_peds, stride,
                                     max_windows=room))
        if max_windows and len(windows) >= max_windows:
            windows = windows[:max_windows]
            break
    if cache and windows:
        try:
            # write to a temp file and atomically replace so an interrupted
            # run never leaves a truncated npz at the final path
            tmp_path = cache_path + f".tmp{os.getpid()}.npz"
            np.savez_compressed(
                tmp_path,
                **{k: np.stack([w[k] for w in windows]) for k in windows[0]})
            os.replace(tmp_path, cache_path)
            # drop caches of the same parameters but an older fingerprint
            prefix = os.path.basename(cache_path).rsplit("_f", 1)[0] + "_f"
            for n in os.listdir(data_dir):
                if (n.startswith(prefix) and n.endswith(".npz")
                        and n != os.path.basename(cache_path)):
                    try:
                        os.remove(os.path.join(data_dir, n))
                    except OSError:
                        pass
        except OSError:
            pass  # read-only data dir: skip caching
    return windows


def batches(windows: List[dict], batch_size: int, rng: np.random.RandomState,
            shuffle: bool = True, drop_last: bool = True) -> Iterator[dict]:
    """drop_last=True keeps every training batch one fixed XLA shape;
    evaluation passes False so a split smaller than batch_size (or its
    remainder) is still scored — at the cost of one extra compile."""
    idx = np.arange(len(windows))
    if shuffle:
        rng.shuffle(idx)
    stop = len(idx) - batch_size + 1 if drop_last else len(idx)
    for s in range(0, max(stop, 0), batch_size):
        sel = idx[s:s + batch_size]
        yield {k: np.stack([windows[i][k] for i in sel]) for k in windows[0]}


# ---------------------------------------------------------------------------
# Benchmark-dataset loaders (reference gst_updated/src/mgnn/trajectories.py
# TrajectoriesDataset + run/create_batch_datasets_eth_ucy.sh conventions).
# Reference-exact windowing semantics; output is our padded fixed-shape
# window dict (the reference materializes variable-ped graphs at batch_size 1
# -- padding to a dataset-wide ped count is the TPU-first replacement).
# ---------------------------------------------------------------------------

def read_file(path: str, delim: str = "\t") -> np.ndarray:
    """Whitespace-tolerant benchmark reader (trajectories.py:160-174
    ``read_file``; 'tab'/'space' names accepted)."""
    if delim == "tab":
        delim = "\t"
    elif delim == "space":
        delim = " "
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(delim) if delim.strip() else \
                line.split()
            if not parts or parts == [""]:
                continue
            rows.append([float(x) for x in parts])
    return np.asarray(rows, np.float64)


def read_sdd_file(path: str) -> np.ndarray:
    """Raw Stanford Drone Dataset annotation parser
    (trajectories_sdd.py:177-198 ``read_sdd_file``): lines of
    ``track_id xmin ymin xmax ymax frame lost occluded generated "label"``.
    Cars and lost boxes are dropped, only every 10th frame is kept
    (30 fps video -> 3 Hz trajectories) and the bbox center becomes the
    position. Returns (N, 4) rows of frame, ped_id, x, y."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip().split()
            if not parts:
                continue
            if parts[-1].strip('"') == "Car":
                continue
            tid, xmin, ymin, xmax, ymax, frame, lost, _occl, _gen = \
                [float(x) for x in parts[:-1]]
            if lost == 1 or frame % 10 != 0:
                continue
            rows.append([frame, tid, (xmin + xmax) / 2.0,
                         (ymin + ymax) / 2.0])
    return np.asarray(rows, np.float64)


def reference_windows(records: np.ndarray, obs_len: int = 8,
                      pred_len: int = 12, skip: int = 1,
                      frame_diff: float = 10.0, mode: str | None = None,
                      max_peds: int | None = None,
                      split_scheme: str = "80/20") -> List[dict]:
    """Windows with the reference's exact selection rules
    (trajectories.py:27-145):

    - candidate start indices stride by ``skip``; ``mode`` splits the index
      range 80/20 into train vs val/test (trajectories.py:45-53)
    - a window is kept iff >= 1 pedestrian is present in ALL seq_len frames
      at exact ``frame_diff`` spacing (trajectories.py:59-68)
    - ALL pedestrians appearing anywhere in the window occupy slots
      (trajectories.py:70-94); first-frame displacement is 0 with rel mask 1
    - pairwise edges A[t, i, j] = pos_i - pos_j; the reference leaves absent
      slots at the -999 fill value and relies on attn_mask downstream
      (utils.py:59-67 seq_to_graph 'rel_conv'); here they are zeroed by the
      presence outer product, which the masked model renders equivalent

    When ``max_peds`` is None the windows are padded to the max pedestrian
    count over the returned windows (rounded up to a multiple of 8 for TPU
    lane alignment); windows exceeding an explicit ``max_peds`` are skipped.
    """
    seq_len = obs_len + pred_len
    frames = np.unique(records[:, 0]).tolist()
    frame_data = {f: records[records[:, 0] == f] for f in frames}
    num_sequences = int(np.floor((len(frames) - seq_len) / skip)) + 1
    hi = num_sequences * skip + 1
    if mode is None:
        idx_range = range(0, hi, skip)
    elif split_scheme == "80/10/10":
        # the sdd variant splits train/val/test 80/10/10 by start index
        # (trajectories_sdd.py:47-56) instead of trajectories.py's 80/20
        bounds = {"train": (0, int(hi * 0.8)),
                  "val": (int(hi * 0.8), int(hi * 0.9)),
                  "test": (int(hi * 0.9), hi)}
        if mode not in bounds:
            raise ValueError(f"unknown mode {mode!r}")
        idx_range = range(*bounds[mode], skip)
    elif mode == "train":
        idx_range = range(0, int(hi * 0.8), skip)
    elif mode in ("val", "test"):
        idx_range = range(int(hi * 0.8), hi, skip)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    raw = []
    for idx in idx_range:
        if idx + seq_len > len(frames):
            continue
        fr = frames[idx:idx + seq_len]
        rows = [frame_data[f] for f in fr]
        cat = np.concatenate(rows, axis=0)
        start_frame = cat[0, 0]
        ped_ids = np.unique(cat[:, 1])
        # survive-all-frames gate (trajectories.py:59-68)
        survive = False
        for p in ped_ids:
            pf = np.unique(cat[cat[:, 1] == p, 0])
            if len(pf) == seq_len and np.all(np.diff(pf) == frame_diff):
                survive = True
                break
        if not survive:
            continue
        P0 = len(ped_ids)
        pos = np.zeros((seq_len, P0, 2), np.float32)
        present = np.zeros((seq_len, P0), np.float32)
        for t in range(seq_len):
            fid = start_frame + t * frame_diff
            sel = cat[cat[:, 0] == fid]
            for j, p in enumerate(ped_ids):
                hit = sel[sel[:, 1] == p]
                if len(hit) > 1:
                    raise RuntimeError(
                        "same pedestrian twice in one frame")
                if len(hit) == 1:
                    pos[t, j] = hit[0, 2:4]
                    present[t, j] = 1.0
        raw.append((pos, present))

    if not raw:
        return []
    if max_peds is None:
        widest = max(p.shape[1] for p, _ in raw)
        max_peds = int(np.ceil(widest / 8) * 8)
    windows = []
    skipped = 0
    for pos, present in raw:
        P0 = pos.shape[1]
        if P0 > max_peds:
            skipped += 1
            continue
        pos_p = np.zeros((seq_len, max_peds, 2), np.float32)
        pres_p = np.zeros((seq_len, max_peds), np.float32)
        pos_p[:, :P0] = pos
        pres_p[:, :P0] = present
        windows.append(_window_arrays(pos_p, pres_p, obs_len, pred_len))
    if skipped:
        # never filter a benchmark split silently (univ/sdd scenes routinely
        # exceed 32 peds) — metrics on a subset are not comparable
        import sys
        print(f"WARNING: dropped {skipped}/{len(raw)} windows whose ped "
              f"count exceeds max_peds={max_peds}", file=sys.stderr)
    return windows


def _repad(windows: List[dict]) -> List[dict]:
    """Pad every window to the dataset-wide max pedestrian-slot count so
    batches stack into one fixed shape (the TPU-first replacement for the
    reference's variable-size batch_size=1 graphs)."""
    if not windows:
        return windows
    widest = max(w["v"].shape[1] for w in windows)
    for i, w in enumerate(windows):
        P0 = w["v"].shape[1]
        if P0 < widest:
            pad = lambda a, axes: np.pad(
                a, [(0, widest - P0) if ax in axes else (0, 0)
                    for ax in range(a.ndim)])
            windows[i] = {
                "v": pad(w["v"], (1,)), "A": pad(w["A"], (1, 2)),
                "attn_mask": pad(w["attn_mask"], (1, 2)),
                "loss_mask": pad(w["loss_mask"], (0,)),
                "loss_mask_rel": pad(w["loss_mask_rel"], (0,)),
            }
    return windows


def read_trajnet_file(path: str):
    """Parse a trajnet++ ndjson file (trajectories_trajnet.py:209-251).

    Returns (records (N, 4) of frame/ped/x/y, frame_diff,
    sorted unique scene start frames). ndjson is plain JSON-per-line, so no
    extra dependency is needed."""
    import json
    if not path.endswith(".ndjson"):
        return np.zeros((0, 4)), 0.0, np.zeros((0,))
    rows, starts, frame_diff = [], [], 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            post = json.loads(line)
            if "scene" in post:
                s = post["scene"]["s"]
                if frame_diff == 0.0:
                    frame_diff = (post["scene"]["e"] - s) / 20
                starts.append(s)
            if "track" in post:
                t = post["track"]
                rows.append([t["f"], t["p"], t["x"], t["y"]])
    return (np.asarray(rows, np.float64), frame_diff,
            np.unique(np.asarray(starts)))


def trajnet_windows(path: str, obs_len: int = 8, pred_len: int = 12,
                    skip: int = 1, mode: str | None = None,
                    max_peds: int | None = None) -> List[dict]:
    """Windows anchored at the file's scene start frames with the reference's
    mode split and skip (trajectories_trajnet.py:37-100; the oversized 'cff'
    scenes force skip=100 there, reproduced here)."""
    records, frame_diff, starts = read_trajnet_file(path)
    if len(records) == 0:
        return []
    if os.path.basename(path)[:3] == "cff":
        skip = 100
    if mode == "train":
        starts = starts[:int(0.8 * len(starts)):skip]
    elif mode in ("val", "test"):
        starts = starts[int(0.8 * len(starts))::skip]
    else:
        starts = starts[::skip]
    seq_len = obs_len + pred_len
    windows = []
    for s in starts:
        fr = s + frame_diff * np.arange(seq_len)
        sel = records[np.isin(records[:, 0], fr)]
        if len(sel) == 0:
            continue
        windows.extend(reference_windows(
            sel, obs_len, pred_len, skip=seq_len, frame_diff=frame_diff,
            mode=None, max_peds=max_peds))
    return windows


def trajnet_testset_windows(path: str, obs_len: int = 8,
                            max_peds: int | None = None):
    """Observation-only windows from a trajnet++ TESTSET ndjson, for
    producing leaderboard predictions (trajectories_trajnet_testset.py:9-197).

    Testset scenes carry obs_seq_len+1 observed frames (anchor + obs — 'they
    have 21 frames. 9 obs, 12 pred', testset loader line 67) and no ground
    truth. A window is kept iff at least one pedestrian is present in all
    obs_len+1 consecutive frames (lines 72-82). Returns (windows, metas):
    windows hold obs-period ``v``/``A``/``attn_mask``/``loss_mask_rel``
    (shapes (obs, P, ...) / (P, obs)); each meta carries what the prediction
    writer needs: scene_id, start frame, frame_diff, last observed absolute
    positions, and the slot -> original ped id map."""
    import json
    rows, scenes, frame_diff = [], [], 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            post = json.loads(line)
            if "scene" in post:
                sc = post["scene"]
                if frame_diff == 0.0:
                    frame_diff = (sc["e"] - sc["s"]) / 20
                scenes.append((sc.get("id", len(scenes)), sc["s"]))
            if "track" in post:
                t = post["track"]
                rows.append([t["f"], t["p"], t["x"], t["y"]])
    if not rows or not scenes:
        return [], []
    records = np.asarray(rows, np.float64)

    raw, metas = [], []
    for scene_id, start in scenes:
        fr = start + frame_diff * np.arange(obs_len + 1)
        sel = records[np.isin(records[:, 0], fr)]
        if len(sel) == 0:
            continue
        ped_ids = np.unique(sel[:, 1])
        pos = np.zeros((obs_len + 1, len(ped_ids), 2), np.float32)
        present = np.zeros((obs_len + 1, len(ped_ids)), np.float32)
        for t, fid in enumerate(fr):
            at_f = sel[sel[:, 0] == fid]
            for j, p in enumerate(ped_ids):
                hit = at_f[at_f[:, 1] == p]
                if len(hit) > 1:
                    raise RuntimeError(
                        "same pedestrian twice in one frame")
                if len(hit) == 1:
                    pos[t, j] = hit[0, 2:4]
                    present[t, j] = 1.0
        # >= 1 ped must survive every one of the obs_len+1 frames
        if not np.any(present.sum(axis=0) == obs_len + 1):
            continue
        raw.append((pos, present))
        metas.append({
            "scene_id": int(scene_id),
            "start_frame": float(start),
            "last_frame": float(fr[-1]),
            "frame_diff": float(frame_diff),
            "ped_ids": ped_ids.astype(np.int64),
            "last_pos": pos[-1].copy(),
            "last_present": present[-1].copy(),
        })

    if max_peds is None:
        widest = max(p.shape[1] for p, _ in raw) if raw else 0
        max_peds = int(np.ceil(max(widest, 1) / 8) * 8)
    windows, kept = [], []
    for (pos, present), meta in zip(raw, metas):
        P0 = pos.shape[1]
        if P0 > max_peds:
            continue
        pos_p = np.zeros((obs_len + 1, max_peds, 2), np.float32)
        pres_p = np.zeros((obs_len + 1, max_peds), np.float32)
        pos_p[:, :P0] = pos
        pres_p[:, :P0] = present
        # build over anchor + obs then drop the anchor frame: the first kept
        # step's displacement is pos(t1) - pos(anchor), matching the
        # reference's tt==0 case (testset loader lines 102-109)
        w = _window_arrays(pos_p, pres_p, obs_len + 1, 0)
        windows.append({
            "v": w["v"][1:],
            "A": w["A"][1:],
            "attn_mask": w["attn_mask"][1:],
            "loss_mask": w["loss_mask"][:, 1:],
            "loss_mask_rel": w["loss_mask_rel"][:, 1:],
        })
        kept.append(meta)
    return windows, kept


def write_trajnet_predictions(out_path: str, metas, predictions):
    """Write trajnet++ leaderboard-format predictions: one
    ``{"track": {"f", "p", "x", "y", "prediction_number", "scene_id"}}``
    ndjson line per pedestrian per predicted frame (the submission format
    the reference's eval_trajnet.py:1-192 targets but never finishes — its
    test() dead-ends in a pdb trace).

    predictions: list aligned with metas; each item is (pred_len, P, 2)
    predicted DISPLACEMENTS per subsampled frame (a single sample), or
    (S, pred_len, P, 2) for S samples -> prediction_number 0..S-1.
    Absolute positions are recovered by cumsum from the last observed
    position (crowd_nav_interface_parallel.py:99-113 convention)."""
    import json
    with open(out_path, "w") as f:
        for meta, pred in zip(metas, predictions):
            pred = np.asarray(pred)
            if pred.ndim == 3:
                pred = pred[None]
            S, T, P, _ = pred.shape
            ped_ids = meta["ped_ids"]
            k = min(P, len(ped_ids))      # drop padded slots beyond the
            for s in range(S):            # window's real pedestrians
                absolute = meta["last_pos"][None, :k] + \
                    np.cumsum(pred[s][:, :k], axis=0)
                for t in range(T):
                    fid = meta["last_frame"] + meta["frame_diff"] * (t + 1)
                    for j in range(k):
                        if not meta["last_present"][j]:
                            continue
                        f.write(json.dumps({"track": {
                            "f": float(fid),
                            "p": int(ped_ids[j]),
                            "x": round(float(absolute[t, j, 0]), 2),
                            "y": round(float(absolute[t, j, 1]), 2),
                            "prediction_number": s,
                            "scene_id": meta["scene_id"],
                        }}) + "\n")


# name -> (subdir under data root, delim, frame_diff); eth/ucy per the
# reference's datasets/eth_ucy layout, 'sj' per utils.py:109-110 (the
# self-collected CrowdNav sim data the shipped checkpoints train on)
BENCHMARKS = {
    "eth": ("eth_ucy/eth", "\t", 10.0),
    "hotel": ("eth_ucy/hotel", "\t", 10.0),
    "univ": ("eth_ucy/univ", "\t", 10.0),
    "zara1": ("eth_ucy/zara1", "\t", 10.0),
    "zara2": ("eth_ucy/zara2", "\t", 10.0),
    # sdd holds RAW annotation files (trajectories_sdd.py read_sdd_file);
    # frames stride 10 after the every-10th-frame filter
    "sdd": ("sdd/social_pool_data", "sdd-raw", 10.0),
    "sj": ("shuijing/orca_20humans_fov", "\t", 1.0),
}


def load_benchmark(dataset: str, data_root: str, split: str = "test",
                   obs_len: int = 8, pred_len: int = 12, skip: int = 1,
                   max_peds: int | None = None,
                   cache: bool = True) -> List[dict]:
    """Load a named benchmark split in the reference's directory layout
    (mgnn/utils.py:100-115 ``load_batch_dataset``).

    eth/ucy: ``<root>/eth_ucy/<name>/{train,val,test}/*.txt`` (pre-split
    files; mode=None). 'sj' / self-collected: flat ``<root>/.../*.txt``
    with the 80/20 in-file mode split (trajectories.py:45-53). Windows are
    cached to ``<dir>/<dataset>_dset_<split>_windows.npz`` -- the analog of
    the reference's ``*_batch_trajectories.pt`` artifacts
    (batch_trajectories.py + utils.py:101).
    """
    if dataset in ("real", "synth", "all"):
        # trajnet++ ndjson scenes (utils.py:104-105 directory convention)
        base = os.path.join(data_root, "trajnet++", "train")
        windows = []
        for name in sorted(os.listdir(base)):
            if not name.endswith(".ndjson"):
                continue
            if dataset != "all" and dataset not in name:
                continue
            windows.extend(trajnet_windows(
                os.path.join(base, name), obs_len, pred_len, skip,
                mode=split, max_peds=max_peds))
        return _repad(windows)
    if dataset in BENCHMARKS:
        sub, delim, frame_diff = BENCHMARKS[dataset]
        base = os.path.join(data_root, sub)
    else:  # arbitrary directory of txt files, sj-style split
        base, delim, frame_diff = os.path.join(data_root, dataset), "\t", 1.0
    split_dir = os.path.join(base, split)
    if os.path.isdir(split_dir):
        data_dir, mode = split_dir, None
    elif os.path.isdir(base):
        data_dir, mode = base, split
    else:
        raise FileNotFoundError(f"no dataset at {base}")

    # window geometry is part of the cache key — a stale cache built at a
    # different obs/pred split would silently mismatch the eval config
    mp_tag = "all" if max_peds is None else str(max_peds)
    cache_path = os.path.join(
        data_dir,
        f"{dataset}_dset_{split}_o{obs_len}p{pred_len}s{skip}"
        f"mp{mp_tag}_windows.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        n = int(z["n"])
        keys = ("v", "A", "attn_mask", "loss_mask", "loss_mask_rel")
        return [{k: z[f"{k}_{i}"] for k in keys} for i in range(n)]

    windows = []
    scheme = "80/10/10" if delim == "sdd-raw" else "80/20"
    for name in sorted(os.listdir(data_dir)):
        if not name.endswith(".txt"):
            continue
        fp = os.path.join(data_dir, name)
        rec = read_sdd_file(fp) if delim == "sdd-raw" else \
            read_file(fp, delim)
        windows.extend(reference_windows(
            rec, obs_len, pred_len, skip, frame_diff, mode, max_peds,
            split_scheme=scheme))
    windows = _repad(windows)
    if cache and windows:
        flat = {"n": np.asarray(len(windows))}
        for i, w in enumerate(windows):
            for k, v in w.items():
                flat[f"{k}_{i}"] = v
        try:
            np.savez_compressed(cache_path, **flat)
        except OSError:
            pass  # read-only dataset dir; skip the cache
    return windows
