"""Fork choice: proto-array LMD-GHOST + spec wrapper.

Twin of ``consensus/proto_array`` + ``consensus/fork_choice``.

The port's copy of ``lighthouse_tpu/fork_choice``.
"""

from .proto_array import ProtoArrayForkChoice, ExecutionStatus
from .fork_choice import ForkChoice, ForkChoiceStore
