"""Episode recorder for sim2real system identification (JAX package
``utils/recorder.py``; reference crowd_sim/envs/utils/recorder.py:5-64).

Accumulates robot actions / wheel velocities / positions / orientations per
episode and writes CSVs in the JAX package's format; ``load_actions`` reads a
recorded action file back for replay through the simulator
(recorder.py:52-56 + crowd_sim.py:169-173). NumPy only.
"""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np


class Recorder:
    def __init__(self):
        self.action_list: List[list] = []
        self.unsmoothed_actions: List[list] = []
        self.wheel_vel_list: List[list] = []
        self.position_list: List[list] = []
        self.orientation_list: List[float] = []
        self.robot_goal: List[list] = []

    def add_step(self, action, position, orientation, wheel_vels=None,
                 unsmoothed=None):
        self.action_list.append(list(np.asarray(action).ravel()))
        self.position_list.append(list(np.asarray(position).ravel()))
        self.orientation_list.append(float(orientation))
        if wheel_vels is not None:
            self.wheel_vel_list.append(list(np.asarray(wheel_vels).ravel()))
        if unsmoothed is not None:
            self.unsmoothed_actions.append(list(np.asarray(unsmoothed).ravel()))

    def save_episode(self, out_dir: str, episode_id: int):
        """Write ``<episode_id>_<name>.csv`` for every non-empty list and
        start a new episode."""
        os.makedirs(out_dir, exist_ok=True)
        for name, rows in (
                ("actions", self.action_list),
                ("unsmoothed_actions", self.unsmoothed_actions),
                ("wheel_velocities", self.wheel_vel_list),
                ("positions", self.position_list),
                ("orientations", [[o] for o in self.orientation_list]),
                ("goals", self.robot_goal)):
            if not rows:
                continue
            path = os.path.join(out_dir, f"{episode_id}_{name}.csv")
            with open(path, "w", newline="") as f:
                csv.writer(f).writerows(rows)
        self.__init__()

    @staticmethod
    def load_actions(path: str) -> np.ndarray:
        """Replayable (T, 2) action array (recorder.py:52-56)."""
        with open(path) as f:
            return np.asarray([[float(x) for x in row]
                               for row in csv.reader(f)])
