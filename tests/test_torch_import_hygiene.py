"""The PyTorch port imports neither jax nor anything of the JAX package, and
none of matplotlib, pandas, rospy and gym (the card's machine has none of
them; the modules that draw or talk to ROS import them when called).

Checked in a fresh interpreter: this test process already imported jax (see
conftest.py).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, sys
import crowdnav_prediction_attngraph_tpu_torch
import crowdnav_prediction_attngraph_tpu_torch.test
import crowdnav_prediction_attngraph_tpu_torch.train
import crowdnav_prediction_attngraph_tpu_torch.algo.ppo
import crowdnav_prediction_attngraph_tpu_torch.algo.gae
import crowdnav_prediction_attngraph_tpu_torch.env.vector
import crowdnav_prediction_attngraph_tpu_torch.models.srnn
import crowdnav_prediction_attngraph_tpu_torch.utils.checkpoint
import crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention
import crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges
import crowdnav_prediction_attngraph_tpu_torch.collect_data
import crowdnav_prediction_attngraph_tpu_torch.env.collect
import crowdnav_prediction_attngraph_tpu_torch.models.gst.dataset
import crowdnav_prediction_attngraph_tpu_torch.models.gst.eval
import crowdnav_prediction_attngraph_tpu_torch.models.gst.losses
import crowdnav_prediction_attngraph_tpu_torch.models.gst.pecnet_data
import crowdnav_prediction_attngraph_tpu_torch.models.gst.temporal_conv
import crowdnav_prediction_attngraph_tpu_torch.models.gst.trainer
import crowdnav_prediction_attngraph_tpu_torch.parallel.mesh
import crowdnav_prediction_attngraph_tpu_torch.parallel.edge_partition
import crowdnav_prediction_attngraph_tpu_torch.parallel.train_step
import crowdnav_prediction_attngraph_tpu_torch.parallel.launch
import crowdnav_prediction_attngraph_tpu_torch.env.lidar
import crowdnav_prediction_attngraph_tpu_torch.env.gym_adapter
import crowdnav_prediction_attngraph_tpu_torch.sim2real
import crowdnav_prediction_attngraph_tpu_torch.plot
import crowdnav_prediction_attngraph_tpu_torch.runtime.native
import crowdnav_prediction_attngraph_tpu_torch.utils.recorder
import crowdnav_prediction_attngraph_tpu_torch.utils.render
import crowdnav_prediction_attngraph_tpu_torch.utils.running_mean_std
import crowdnav_prediction_attngraph_tpu_torch.utils.profiling
import crowdnav_prediction_attngraph_tpu_torch.utils.orca_oracle
import crowdnav_prediction_attngraph_tpu_torch.utils.torch_import
from crowdnav_prediction_attngraph_tpu_torch import train
train._parser().parse_args(["--multihost", "--coordinator-address",
                            "127.0.0.1:1", "--num-hosts", "2",
                            "--process-id", "0", "--tp", "2"])
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m.startswith("jaxlib") or m.startswith("flax")
                        or m.startswith("orbax")
                        or m.split(".")[0] in ("matplotlib", "pandas",
                                               "rospy", "gym")
                        or m == "crowdnav_prediction_attngraph_tpu"
                        or m.startswith("crowdnav_prediction_attngraph_tpu."))))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
