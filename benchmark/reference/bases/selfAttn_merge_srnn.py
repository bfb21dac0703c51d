"""The attention interaction-graph base of ``robot.policy =
"selfAttn_merge_srnn"`` (the plain copy in ``reference/policy_net.py``)."""

from ..policy_net import SelfAttnMergeSRNN as Base

__all__ = ["Base"]
