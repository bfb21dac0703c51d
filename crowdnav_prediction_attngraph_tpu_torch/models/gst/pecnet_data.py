"""PECNet-style SDD "social pool" data tooling (reference
gst_updated/src/pec_net/social_utils.py + sdd_trajectories.py).

The port's own copy of the JAX package's ``models/gst/pecnet_data.py``
(numpy only; the port imports nothing of the JAX package).

The reference vendors PECNet's pipeline: scene txt files (frame, ped, x, y)
are greedily grouped into social batches — a seed trajectory plus every
trajectory passing a time/distance proximity filter — with a block
social-adjacency mask, pickled as ``[traj_batches, mask_batches]``
(social_utils.py:66-150), and re-loaded by ``SocialDataset`` with
reversed-tracklet train augmentation and /1000-scaled initial positions
(social_utils.py:173-232). Nothing in the reference ever consumes
``SDDTrajectoriesDataset``; this module reimplements the live parts in
plain numpy so the pickle artifacts interoperate both ways.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np


def find_min_time(t1: np.ndarray, t2: np.ndarray) -> float:
    """Min |frame gap| between either track's first frame and the other's
    first 8 frames (social_utils.py:19-31 — asymmetric on purpose)."""
    t1, t2 = np.asarray(t1)[:8], np.asarray(t2)[:8]
    return float(min(np.abs(t1[0] - t2).min(), np.abs(t2[0] - t1).min()))


def find_min_dist(p1x, p1y, p2x, p2y) -> float:
    """Min pairwise distance over the first 8 positions of both tracks
    (social_utils.py:33-44; note the reference iterates len(p1x) twice,
    which we reproduce — p2 is indexed by p1's length)."""
    p1x, p1y = np.asarray(p1x)[:8], np.asarray(p1y)[:8]
    p2x, p2y = np.asarray(p2x)[:8], np.asarray(p2y)[:8]
    n = len(p1x)
    d = np.hypot(p2x[:n, None] - p1x[None, :n],
                 p2y[:n, None] - p1y[None, :n])
    return float(d.min())


def social_and_temporal_filter(p1_traj, p2_traj, time_thresh=48,
                               dist_thresh=100) -> bool:
    """(social_utils.py:46-57)"""
    p1, p2 = np.asarray(p1_traj), np.asarray(p2_traj)
    if find_min_time(p1[:, 1], p2[:, 1]) > time_thresh:
        return False
    if find_min_dist(p1[:, 2], p1[:, 3], p2[:, 2], p2[:, 3]) > dist_thresh:
        return False
    return True


def collect_social_batches(files: Sequence[str], batch_size=512,
                           time_thresh=48, dist_thresh=100,
                           delim=" ", verbose=False):
    """Greedy social grouping of scene txt files into
    (full_dataset, full_masks) exactly as social_utils.py:66-150: pop the
    first remaining track as a seed, absorb every track passing the filter,
    mark the group's block in the mask, flush when batch_size is reached.
    Rows per track: (person_id, frame_id, x, y)."""
    full_dataset: List[list] = []
    full_masks: List[np.ndarray] = []
    current_batch: List[list] = []
    msize = int(batch_size * 1.5)
    mask_batch = np.zeros((msize, msize), np.int64)
    current_size = 0

    for path in files:
        data = np.loadtxt(path, delimiter=delim)
        data_by_id: dict = {}
        for frame_id, person_id, x, y in data:
            data_by_id.setdefault(person_id, []).append(
                [person_id, frame_id, x, y])
        all_data_dict = data_by_id.copy()
        if verbose:
            print("Total People: ", len(data_by_id))
        while data_by_id:
            curr_keys = list(data_by_id.keys())
            if current_size >= batch_size:
                full_dataset.append(current_batch.copy())
                full_masks.append(
                    mask_batch[:len(current_batch), :len(current_batch)]
                    .copy())
                current_size = 0
                current_batch = []
                mask_batch = np.zeros((msize, msize), np.int64)
            related = [current_size]
            current_batch.append(all_data_dict[curr_keys[0]])
            current_size += 1
            seed = curr_keys[0]
            del data_by_id[seed]
            for k in curr_keys[1:]:
                if social_and_temporal_filter(
                        all_data_dict[seed], all_data_dict[k],
                        time_thresh, dist_thresh):
                    current_batch.append(all_data_dict[k])
                    related.append(current_size)
                    current_size += 1
                    del data_by_id[k]
            idx = np.asarray(related)
            mask_batch[np.ix_(idx, idx)] = 1

    full_dataset.append(current_batch)
    full_masks.append(
        mask_batch[:len(current_batch), :len(current_batch)].copy())
    return full_dataset, full_masks


def save_social_pickle(out_path: str, full_dataset, full_masks) -> None:
    """Pickle in the reference's ``[traj, masks]`` layout
    (social_utils.py:136-150 generate_pooled_data)."""
    with open(out_path, "wb") as f:
        pickle.dump([full_dataset, full_masks], f)


def initial_pos(traj_batches) -> List[np.ndarray]:
    """Start-of-future positions, /1000 scaled (social_utils.py:152-158)."""
    return [np.asarray(b)[:, 7, :].copy() / 1000 for b in traj_batches]


def load_social_pickle(path: str, set_name: str = "train",
                       keep_id: bool = False) -> dict:
    """SocialDataset equivalent (social_utils.py:173-232): loads a
    ``social_pool_data`` pickle, strips (person, frame) columns unless
    ``keep_id``, doubles the train set with time-reversed tracklets, and
    attaches /1000-scaled initial positions."""
    with open(path, "rb") as f:
        traj, masks = pickle.load(f)
    traj_new, masks_new = [], []
    for t, m in zip(traj, masks):
        t = np.asarray(t, np.float64)
        if not keep_id:
            t = t[:, :, 2:]
        traj_new.append(t)
        masks_new.append(np.asarray(m))
        if set_name == "train":
            traj_new.append(np.flip(t, axis=1).copy())
            masks_new.append(np.asarray(m))
    return {
        "trajectory_batches": traj_new,
        "mask_batches": masks_new,
        "initial_pos_batches": initial_pos(traj_new),
    }


def sdd_pickle_path(pkg_root: str, set_name: str, b_size=4096,
                    t_thresh=60, d_thresh=50, scene: str | None = None):
    """Reference pickle naming convention (social_utils.py:177-180)."""
    tag = "all_" if scene is None else scene[:-2] + scene[-1] + "_"
    return os.path.join(
        pkg_root, "datasets/sdd/social_pool_data",
        f"{set_name}_{tag}{b_size}_{t_thresh}_{d_thresh}.pickle")


def split_square_block_matrix(block_mat: np.ndarray) -> List[int]:
    """Social-group sizes from a block-diagonal mask
    (social_utils.py:241-253)."""
    block_mat = np.asarray(block_mat)
    sizes, start, curr = [], 0, 1
    for i in range(1, block_mat.shape[0]):
        if block_mat[start, i] != 0:
            curr += 1
        else:
            sizes.append(curr)
            curr = 1
            start = i
    sizes.append(curr)
    return sizes
