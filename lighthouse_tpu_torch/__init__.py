"""lighthouse_tpu_torch: the PyTorch/CUDA port of ``lighthouse_tpu``'s device path.

The JAX package ``lighthouse_tpu`` stays the reference; this package is its
port to one NVIDIA Hopper GPU. It imports ``torch`` and numpy only — never
``jax`` and nothing of ``lighthouse_tpu`` (what it needs of the reference's
framework-free modules lives here as its own copy, pinned by tests).

The first slice ports batched BLS12-381 signature-set verification
(``bls.backend.verify_indexed_sets_device``). Every field multiply on that
path runs through the two hand-written CUDA kernels of ``csrc/fused_mul.cu``
(bound in ``ops/bls/fused_mul.py``), the port of the reference's only Pallas
kernel: the plan kernel (one multiply step, input lincombs included) and the
chain kernel (a whole fixed-exponent chain in one launch). Over them run the
``bls`` signature-set API and the gossip ``firehose``; the consensus host
layers (``ssz``, ``types``, ``state_transition``) are the port's own copies,
block processing sending its one bulk signature batch to the ``bls`` device
arm, and ``epoch_engine`` runs every epoch boundary as a PyTorch sweep on the
device. Over them the node's own layers are copied: ``beacon_chain`` (block
import, the gossip batch paths and the firehose, with the validator pubkeys
resident on the device), ``fork_choice``, ``store``, ``op_pool`` and the
``beacon_processor`` scheduler. Over the chain runs the client surface:
``client`` (the node builder), ``http_api`` (the Beacon API), ``cli``
(``python -m lighthouse_tpu_torch bn``), ``http_metrics``, ``api_client``,
``execution_layer`` and ``eth1``.

Device rule: every entry point takes ``device=``; the default is CUDA, and
with no CUDA device the default raises — nothing drops to the CPU unless the
caller asks for it (the CPU tests pass ``device="cpu"``). Importing the
package touches no device.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.2.0"
