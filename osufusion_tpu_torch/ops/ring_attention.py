"""Ring attention (K6): exact global attention over a sequence-sharded frame
axis, the counterpart of the ring section of
``osufusion_tpu/ops/pallas_attention.py`` (``_ring_fwd``, ``_ring_bwd``,
``ring_flash_attention_local``).

Each of n ranks keeps its queries (B, T, H, D) and passes its chunk of keys
and values round the ring, one hop at a time: at hop j a rank holds the chunk
of rank (i - j) mod n. The forward runs K1 (``flash_fwd``, global, with its
base-2 LSE) on its queries against the chunk that is here and folds that
hop's normalised partial into fp32 accumulators by the exact rule on the two
LSEs (``ring_merge``, ``csrc/ring_merge.cu``); the last hop's merge writes o
in q's dtype. The backward runs K2 in its three parts: the pre-pass once, with the
global o, LSE and do, so that every chunk's probabilities are the globally
normalised ones; one sweep per hop over the chunk that is here, whose dq
atomics keep adding into one fp32 buffer and which adds its dk and dv into
fp32 accumulators that travel with their chunk and arrive home after n hops;
the post-pass once. Per-rank memory stays O(T_local).

The JAX package runs a grouped site (DiT: H = Kv; MMDiT: H = 8, Kv = 2) as one
ring per KV head; here every KV head hops at once through the grouped forms
of K1 and K2, which sends fewer messages per hop and gives the same result. A
site with rotary tables (the UNet's MQA sites) passes this rank's rows of the
tables to K1 and to K2's pre-pass (q rotated there); k travels rotated, and
its gradient, still in the rotated frame when it arrives home, is un-rotated
there with the home rows, as ``ops/flash_attention.py::_attention_backward``
does.

The hops move tensors through a rotation that the caller supplies
(``parallel/ring.py`` over a process group): ``rotation.count`` ranks and
``rotation.start(t, tag)``, which posts the send of t to the next rank and the
receive of the previous rank's into a new buffer, and returns a transfer whose
``wait()`` gives that buffer. ``ring_fwd`` posts the next hop's transfer
before the hop's kernels and waits after them; ``ring_bwd`` posts the travel
of dk and dv after the sweep that adds into them. ``ring_attention_op`` is the
differentiable function over them (a ``torch.library.custom_op``, so that a
rematerialisation policy can keep its outputs): on CUDA tensors it launches
the kernels and raises on what they do not take, on CPU tensors it runs their
plain versions hop by hop.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.rope import unapply_rope

# transfer tags: the chunk of keys and values, and its travelling gradients
KV_TAG, DKV_TAG = 0, 1


class KernelParts:
    """The ring's parts on CUDA tensors: K1 with its LSE, the merge, and K2's
    pre-pass, accumulating sweep and post-pass, or at every other form that a
    kernel takes their forms instances (the wrappers choose by the operands'
    dtype and head dim; the forms sweep is the dq and dk/dv kernels, each
    storing on the first hop and adding after)."""

    @staticmethod
    def forward(q, k, v, cos, sin):
        return fa.flash_fwd(q, k, v, cos, sin, -1, q.shape[-1] ** -0.5, return_lse=True)

    @staticmethod
    def merge(o_acc, lse_acc, o_j, lse_j, last: bool):
        """(o_acc, lse, o): o is the output on the ``last`` hop, else None."""
        return fa.ring_merge(o_acc, lse_acc, o_j, lse_j, last)

    @staticmethod
    def backward_prep(q, k, v, o, lse, do, cos, sin):
        return fa.flash_bwd_prep(q, k, v, o, lse, do.contiguous(), cos, sin, q.shape[-1] ** -0.5)

    @staticmethod
    def backward_sweep(state, k, v, dk, dv, accumulate: bool) -> None:
        fa.flash_bwd_sweep(k, v, state, dk, dv, accumulate)

    @staticmethod
    def backward_post(state, cos, sin):
        return fa.flash_bwd_post(state, cos, sin, state.qs.shape[-1] ** -0.5)


class PlainParts:
    """The same parts in fp32 PyTorch: the plain versions of K1 and of the
    split backward at window -1, and the plain merge. The backward's state is
    its operands and the fp32 dq that each hop adds to."""

    @staticmethod
    def forward(q, k, v, cos, sin):
        return fa.flash_fwd_lse_reference(q, k, v, cos, sin, -1)

    @staticmethod
    def merge(o_acc, lse_acc, o_j, lse_j, last: bool):
        o_acc, lse = fa.ring_merge_reference(o_acc, lse_acc, o_j, lse_j)
        return o_acc, lse, o_acc if last else None

    @staticmethod
    def backward_prep(q, k, v, o, lse, do, cos, sin):
        return {"operands": (q, o, lse, do, cos, sin), "dq": torch.zeros(q.shape, dtype=torch.float32, device=q.device)}

    @staticmethod
    def backward_sweep(state, k, v, dk, dv, accumulate: bool) -> None:
        q, o, lse, do, cos, sin = state["operands"]
        state["dq"] += fa.flash_bwd_dq_reference(q, k, v, o, lse, do, cos, sin, -1)
        dk_j, dv_j = fa.flash_bwd_dkv_reference(q, k, v, o, lse, do, cos, sin, -1)
        for acc, part in ((dk, dk_j), (dv, dv_j)):
            if accumulate:
                acc.add_(part)
            else:
                acc.copy_(part)

    @staticmethod
    def backward_post(state, cos, sin):
        return state["dq"]


def _parts(q: torch.Tensor):
    return KernelParts if q.is_cuda else PlainParts


def ring_fwd(q, k_rot, v, cos, sin, rotation, parts=None):
    """This rank's queries q (B, T, H, D) against every rank's keys: k_rot (B,
    T, D) or (B, T, Kv, D), rotated with this rank's rows of the tables cos,
    sin (T, D) (or None), and v, k_rot's shape. Returns (o, lse): o (B, T, H,
    D), in q's dtype from the kernels, fp32 from the plain parts; lse (B, T*H) fp32,
    the global base-2 LSE. ``parts`` defaults to the kernels for CUDA tensors
    and the plain versions for CPU tensors."""
    parts = parts or _parts(q)
    n = rotation.count
    kv = torch.stack([k_rot, v])  # one message a hop
    o_acc = lse = o = None
    for hop in range(n):
        transfer = rotation.start(kv, KV_TAG) if hop + 1 < n else None
        o_j, lse_j = parts.forward(q, kv[0], kv[1], cos, sin)
        o_acc, lse, o = parts.merge(o_acc, lse, o_j, lse_j, hop + 1 == n)
        if transfer is not None:
            kv = transfer.wait()
    return o, lse


def ring_bwd(q, k_rot, v, o, lse, do, cos, sin, rotation, parts=None):
    """The gradients of ``ring_fwd``'s o, from this rank's o and LSE (the
    global ones) and do: (dq in the raw q's frame, dk_rot in the rotated frame,
    dv). dq is in q's dtype from the kernels (fp32 from the plain parts), dk_rot and
    dv fp32; each holds every rank's contribution."""
    parts = parts or _parts(q)
    n = rotation.count
    state = parts.backward_prep(q, k_rot, v, o, lse, do, cos, sin)
    kv = torch.stack([k_rot, v])
    dkv = torch.empty(kv.shape, dtype=torch.float32, device=q.device)
    for hop in range(n):
        transfer = rotation.start(kv, KV_TAG) if hop + 1 < n else None
        parts.backward_sweep(state, kv[0], kv[1], dkv[0], dkv[1], accumulate=hop > 0)
        travel = rotation.start(dkv, DKV_TAG)  # after the sweep that adds into it, in stream order
        if transfer is not None:
            kv = transfer.wait()
        dkv = travel.wait()
    return parts.backward_post(state, cos, sin), dkv[0], dkv[1]


class LocalRing:
    """n ranks of a ring as threads of one process on one device, for
    checking and timing the ring on one card: ``run(fn)`` calls ``fn(rank,
    rotation)`` for every rank at once, each in a thread of its own, and
    returns their results in rank order. A transfer hands the tensor itself
    to the next rank; on one device every kernel goes to the same stream in
    the order the threads queue it, after the kernels that wrote what it
    reads. A rank that fails leaves the others waiting ``timeout`` seconds."""

    def __init__(self, count: int, timeout: float = 600.0) -> None:
        self.count, self.timeout = count, timeout
        self.inboxes = [{tag: queue.SimpleQueue() for tag in (KV_TAG, DKV_TAG)} for _ in range(count)]

    def rotation(self, rank: int) -> "_LocalRotation":
        return _LocalRotation(self, rank)

    def run(self, fn) -> list:
        with ThreadPoolExecutor(self.count) as pool:
            return [f.result() for f in [pool.submit(fn, r, self.rotation(r)) for r in range(self.count)]]


class _LocalRotation:
    def __init__(self, ring: LocalRing, rank: int) -> None:
        self.ring, self.rank, self.count = ring, rank, ring.count

    def start(self, t: torch.Tensor, tag: int):
        self.ring.inboxes[(self.rank + 1) % self.count][tag].put(t)
        inbox = self.ring.inboxes[self.rank][tag]
        return _LocalTransfer(lambda: inbox.get(timeout=self.ring.timeout))


class _LocalTransfer:
    def __init__(self, wait) -> None:
        self.wait = wait


# rotation id -> rotation: the op takes an id, since its arguments are tensors and numbers
_ROTATIONS: dict[int, object] = {}


def register_rotation(rotation) -> int:
    """Give ``rotation`` an id that ``ring_attention_op`` takes."""
    key = len(_ROTATIONS)
    _ROTATIONS[key] = rotation
    return key


@torch.library.custom_op("osufusion_tpu_torch::ring_attention", mutates_args=())
def ring_attention_op(
    q: torch.Tensor,  # (B, T, H, D) raw: this rank's queries
    k: torch.Tensor,  # (B, T, D) (MQA) or (B, T, Kv, D), raw: this rank's keys
    v: torch.Tensor,  # k's shape
    cos: Optional[torch.Tensor],  # (T, D) fp32: this rank's rows of the tables, or None; they get no gradient
    sin: Optional[torch.Tensor],
    rotation: int,  # a ``register_rotation`` id
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global self-attention of this rank's frames against the whole
    sequence, with rotary embedding when given tables, differentiable in q, k
    and v. Returns (o, lse2, k_rot) as ``flash_attention_op`` does: the
    backward's residuals beside q and v, so that a rematerialisation policy
    that keeps this op's outputs never runs the forward ring again; k_rot is
    empty without tables. Every rank of the rotation must call it, and its
    backward, in the same order."""
    k_rot = k if cos is None else fa.rotated_k(k, cos, sin)
    o, lse = ring_fwd(q, k_rot, v, cos, sin, _ROTATIONS[rotation])
    return o.to(q.dtype), lse, k.new_empty(0) if cos is None else k_rot


@ring_attention_op.register_fake
def _(q, k, v, cos, sin, rotation):
    B, T, H, _ = q.shape
    return (torch.empty_like(q), q.new_empty((B, T * H), dtype=torch.float32),
            k.new_empty(0) if cos is None else torch.empty_like(k))


def _save_residuals(ctx, inputs, output) -> None:
    q, k, v, cos, sin, rotation = inputs
    o, lse, k_rot = output
    ctx.save_for_backward(q, k if cos is None else k_rot, v, o, lse, cos, sin)
    ctx.rotation = rotation
    ctx.mark_non_differentiable(lse, k_rot)
    ctx.set_materialize_grads(False)


def _ring_backward(ctx, do, _dlse, _dk_rot):
    q, k_rot, v, o, lse, cos, sin = ctx.saved_tensors
    dq, dk_rot, dv = ring_bwd(q, k_rot, v, o, lse, do, cos, sin, _ROTATIONS[ctx.rotation])
    # the home chunk's gradient, in its rotated frame: the adjoint of its rotation, fp32 on the small tensor
    dk = dk_rot if cos is None else unapply_rope(dk_rot, cos, sin)
    return dq.to(q.dtype), dk.to(k_rot.dtype), dv.to(v.dtype), None, None, None


ring_attention_op.register_autograd(_ring_backward, setup_context=_save_residuals)
