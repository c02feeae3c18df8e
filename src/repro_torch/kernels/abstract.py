"""The shape-only route of the kernels, and the work it counts.

Every kernel module has, beside ``<fn>_cuda`` (the launch wrapper) and
``<fn>_plain`` (its PyTorch version), a ``<fn>_abstract`` with the same
signature: it runs the kernel's argument checks, allocates exactly the
kernel's outputs (shapes, dtypes, the ``out=`` checks) with
``new_empty`` on its input, reads nothing back to the host, and adds
the kernel's work to :data:`WORK`.  A public function sends a
``FakeTensor`` (a tensor with no data, made under
``torch._subclasses.fake_tensor.FakeTensorMode``) there, a CUDA tensor
to the kernel and a CPU tensor to the plain version; nothing falls back
from one route to another.  This route exists for the dry run
(``launch/dryrun.py``), which traces one rank of a production mesh on
fake tensors: the plain versions read the plan's group offsets to the
host, which a tensor without data cannot give.

The work is the cost model's (``kernels/plan.py``: :func:`gemm_work`,
:func:`wgrad_work`, :func:`quantize_bytes`, :func:`act_quant_bytes`,
:func:`flash_attention_work`) over the static M, the routed capacity:
the routing is unknown without data, so every visit of the worst-case
plan counts, as the reference's static shapes assume.  The route is not
an entry of the operator registry (``kernels/dispatch.py``): the table's
``resolve`` picks by device, and a fake tensor's device is the CPU or a
card like a real one's.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: kernel name -> {"calls", "flops", "bytes"} of the shape-only launches
WORK: "dict[str, dict]" = {}


def is_fake(t) -> bool:
    """Whether ``t`` is a tensor without data (a ``FakeTensor``)."""
    return isinstance(t, FakeTensor)


def count(name: str, flops: float, nbytes: int) -> None:
    """Add one shape-only launch of ``name`` doing ``flops`` and moving
    ``nbytes`` to :data:`WORK`."""
    w = WORK.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0})
    w["calls"] += 1
    w["flops"] += float(flops)
    w["bytes"] += int(nbytes)


def reset() -> None:
    WORK.clear()


def aligned(t: torch.Tensor) -> bool:
    """Whether a kernel operand's storage is 16-byte aligned; a tensor
    without data has no address, and passes."""
    return is_fake(t) or t.data_ptr() % 16 == 0
