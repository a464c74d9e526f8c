"""Wrappers of the CUDA window front-end kernels (``csrc/event_select.cu``).

Counterpart of ``repro.kernels.event_select``: ``select_events`` (the
first m of the (time, seq) order by a radix selection; a bitonic sort when
2m > min(n_pad, 1024)) / ``sort_events`` (bitonic), ``group_by_kind``
(stable same-kind grouping, an int32, bool or uint8 active mask),
``trace_rank`` (exclusive prefix count of an
int32, bool or uint8 mask), ``route_rank`` (stable within-bucket ranks),
``ring_slots`` (free-ring insert slots) and ``fused_select`` (the whole
window front end, its selection the same radix selection or bitonic sort).
Each wrapper checks device, dtype, shape and contiguity, allocates fresh
outputs with ``torch.empty`` (``fused_select`` and ``group_by_kind`` one
allocation carved into their outputs), launches on the current
stream (its raw handle, no ``torch.cuda.Stream`` object), raises if the
launch was refused, and adds one to its entry of :data:`LAUNCHES`. They
take CUDA tensors only; ``ops`` sends CPU tensors to the plain versions in
``ref``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import FusedSelect

# Per-kernel launch counts: the proof that a run went through the kernels.
LAUNCHES = {"select_events": 0, "group_by_kind": 0, "trace_rank": 0,
            "route_rank": 0, "ring_slots": 0, "fused_select": 0}

# 12 bytes per padded slot must fit one block's 227 KB of shared memory.
MAX_SORT_SLOTS = 16384
MAX_KINDS = 32
# trace_rank's and group_by_kind's masks: bytes an entry
MASK_BYTES = {torch.int32: 4, torch.bool: 1, torch.uint8: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, *tensors: torch.Tensor, dtype=torch.int32,
           shape=None) -> None:
    """CUDA, ``dtype``, contiguous, all of one non-empty ``shape`` (default:
    the first tensor's, which must be (A, n)). Four reads a tensor; the
    message is worked out only on a refusal."""
    shape = tensors[0].shape if shape is None else torch.Size(shape)
    for t in tensors:
        if not (t.is_cuda and t.dtype == dtype and t.shape == shape
                and t.is_contiguous()):
            raise _refusal(name, tensors, dtype, shape)
    if len(shape) < 2 or 0 in shape:
        raise _refusal(name, tensors, dtype, shape)


def _refusal(name: str, tensors, dtype, shape) -> ValueError:
    for t in tensors:
        if not t.is_cuda:
            return ValueError(f"{name}: expects CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            return ValueError(f"{name}: expects {dtype}, got {t.dtype}")
        if t.shape != shape or len(shape) < 2:
            got = [tuple(x.shape) for x in tensors]
            return ValueError(f"{name}: expects matching {tuple(shape)} "
                              f"tensors, got {got}")
        if not t.is_contiguous():
            return ValueError(f"{name}: expects contiguous tensors")
    return ValueError(f"{name}: empty input {tuple(shape)}")


def _check_mask(mask: torch.Tensor) -> int:
    """trace_rank's (A, n) mask: contiguous, on the card, int32, bool or
    uint8. Returns its bytes an entry."""
    nbytes = MASK_BYTES.get(mask.dtype)
    if (nbytes is None or not mask.is_cuda or mask.dim() != 2
            or not mask.is_contiguous() or 0 in mask.shape):
        raise ValueError(f"trace_rank: expects a contiguous non-empty (A, n) "
                         f"CUDA int32, bool or uint8 mask, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    return nbytes


def _check_cursor(name: str, x: torch.Tensor, n_agents: int) -> None:
    """An (A,) int32 ring cursor on the card (read by the kernel there)."""
    if not x.is_cuda or x.dtype != torch.int32 or tuple(x.shape) != (
            n_agents,) or not x.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous CUDA int32 "
                         f"({n_agents},) cursor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _sort_pad(name: str, cap: int) -> int:
    n_pad = 1 << max((cap - 1).bit_length(), 1)
    if n_pad > MAX_SORT_SLOTS:
        raise ValueError(
            f"{name}: pool_cap {cap} pads to {n_pad} slots; one block's "
            f"shared memory holds at most {MAX_SORT_SLOTS}")
    return n_pad


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launch(name: str, fn, t: torch.Tensor, *args) -> None:
    """``fn(*args, stream)`` on the current stream of ``t``'s card; raises on
    a nonzero launch status."""
    err = fn(*args, _stream(t))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _lib():
    return build.library("event_select")


def select_events(time_key: torch.Tensor, seq: torch.Tensor,
                  exec_cap: int) -> torch.Tensor:
    """(A, cap) keys -> (A, min(exec_cap, cap)) slot indices: the prefix of
    each agent's stable (time, seq) sort, ties broken by slot index."""
    _check("select_events", time_key, seq)
    A, cap = time_key.shape
    n_pad = _sort_pad("select_events", cap)
    m = min(int(exec_cap), cap)
    if m < 1:
        raise ValueError(f"select_events: exec_cap must be >= 1, got "
                         f"{exec_cap}")
    out = torch.empty((A, m), dtype=torch.int32, device=time_key.device)
    _launch("select_events", _lib().launch_select_events, time_key,
            _ptr(time_key), _ptr(seq), _ptr(out), A, cap, n_pad, m)
    return out


def sort_events(time_key: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """(A, cap) keys -> (A, cap) permutation ascending by (time, seq)."""
    return select_events(time_key, seq, time_key.shape[1])


def _check_group(kind: torch.Tensor, active: torch.Tensor,
                 n_kinds: int) -> int:
    """group_by_kind's inputs in one pass: (A, m) contiguous non-empty CUDA
    int32 kinds, a mask of the same shape (int32, bool or uint8) and
    ``n_kinds`` in [1, MAX_KINDS]. Returns the mask's bytes an entry."""
    nbytes = MASK_BYTES.get(active.dtype)
    if not (nbytes and kind.is_cuda and active.is_cuda
            and kind.dtype == torch.int32 and kind.dim() == 2
            and active.shape == kind.shape and kind.is_contiguous()
            and active.is_contiguous() and kind.numel() > 0
            and 1 <= n_kinds <= MAX_KINDS):
        raise ValueError(
            f"group_by_kind: expects contiguous non-empty (A, m) CUDA int32 "
            f"kinds, an int32, bool or uint8 mask of their shape and n_kinds "
            f"in [1, {MAX_KINDS}]; got {kind.dtype} {tuple(kind.shape)} on "
            f"{kind.device}, {active.dtype} {tuple(active.shape)} on "
            f"{active.device}, n_kinds {n_kinds}")
    return nbytes


def group_by_kind(kind: torch.Tensor, active: torch.Tensor, n_kinds: int):
    """(A, m) int32 kinds and an active mask (int32, bool or uint8, nonzero
    active; read as it comes) -> ``(order, rank, counts)``: active rows
    first grouped by ascending kind (clipped into range) and stable in
    position, inactive rows last; ``rank`` aligned with ``order``;
    ``counts`` (A, n_kinds). The three are views of one allocation."""
    nbytes = _check_group(kind, active, n_kinds)
    A, m = kind.shape
    am = A * m
    buf = torch.empty(2 * am + A * n_kinds, dtype=torch.int32,
                      device=kind.device)
    p = buf.data_ptr()
    _launch("group_by_kind", _lib().launch_group_by_kind, kind,
            kind.data_ptr(), active.data_ptr(), nbytes, p, p + 4 * am,
            p + 8 * am, A, m, n_kinds)
    return (buf.as_strided((A, m), (m, 1)),
            buf.as_strided((A, m), (m, 1), am),
            buf.as_strided((A, n_kinds), (n_kinds, 1), 2 * am))


def trace_rank(mask: torch.Tensor) -> torch.Tensor:
    """(A, n) int32, bool or uint8 mask (nonzero counts) -> (A, n) int32
    exclusive prefix counts. The mask is read as it comes: no int32 copy."""
    nbytes = _check_mask(mask)
    out = torch.empty_like(mask, dtype=torch.int32)
    _launch("trace_rank", _lib().launch_trace_rank, mask,
            _ptr(mask), nbytes, _ptr(out), *mask.shape)
    return out


@functools.cache
def _max_keys() -> int:
    """The kernel's bucket table (``max_keys()``), read once, when the
    library is loaded."""
    return _lib().max_keys()


def route_rank(dst_agent: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(A, n) bucket ids -> (A, n) stable within-bucket ranks.

    Key-range contract: every ``dst_agent`` value lies in
    ``[0, n_buckets)`` (the engine passes agent ids with ``A`` as the
    sentinel of invalid rows, so ``n_buckets = A + 1``); ``n_buckets`` is at
    most the kernel's shared-memory key table. A key outside the range gets
    an unspecified rank and leaves the other rows' ranks as they are. The
    plain version ``ref.route_rank`` takes any keys."""
    _check("route_rank", dst_agent)
    if dst_agent.dim() != 2 or not 1 <= n_buckets <= _max_keys():
        raise ValueError(f"route_rank: expects (A, n) buckets and n_buckets "
                         f"in [1, {_max_keys()}], got "
                         f"{tuple(dst_agent.shape)} and {n_buckets}")
    out = torch.empty_like(dst_agent)
    _launch("route_rank", _lib().launch_route_rank, dst_agent,
            dst_agent.data_ptr(), out.data_ptr(), *dst_agent.shape, n_buckets)
    return out


def _check_ring(free_ring: torch.Tensor, head: torch.Tensor,
                want: torch.Tensor) -> None:
    """ring_slots' inputs in one pass: contiguous CUDA tensors, an (A, cap)
    int32 ring, an (A,) int32 head and an (A, n) bool mask, none empty. The
    mask may start anywhere: the kernel reads it in aligned words."""
    A = free_ring.shape[0] if free_ring.dim() == 2 else -1
    if not (free_ring.is_cuda and head.is_cuda and want.is_cuda
            and free_ring.dtype == torch.int32 and head.dtype == torch.int32
            and want.dtype == torch.bool and want.dim() == 2
            and want.shape[0] == A and head.shape == (A,)
            and free_ring.numel() > 0 and want.numel() > 0
            and free_ring.is_contiguous() and head.is_contiguous()
            and want.is_contiguous()):
        raise ValueError(
            f"ring_slots: expects contiguous non-empty CUDA tensors: an (A, "
            f"cap) int32 ring, an (A,) int32 head and an (A, n) bool mask; "
            f"got {free_ring.dtype} {tuple(free_ring.shape)} on "
            f"{free_ring.device}, {head.dtype} {tuple(head.shape)} on "
            f"{head.device}, {want.dtype} {tuple(want.shape)} on "
            f"{want.device}")


def ring_slots(free_ring: torch.Tensor, head: torch.Tensor,
               want: torch.Tensor) -> torch.Tensor:
    """(A, cap) int32 free ring, (A,) int32 head, (A, n) bool insert mask ->
    (A, n) int32 slots ``free_ring[a, (head[a] + rank) % cap]``, ``rank``
    the exclusive count of wanted rows before each row (int32 wrap, floor
    modulo)."""
    _check_ring(free_ring, head, want)
    out = torch.empty_like(want, dtype=torch.int32)
    _launch("ring_slots", _lib().launch_ring_slots, want,
            free_ring.data_ptr(), head.data_ptr(), want.data_ptr(),
            out.data_ptr(), free_ring.shape[0], free_ring.shape[1],
            want.shape[1])
    return out


# fused_select's int32 outputs in one allocation, in this order; then the
# payload words, the per-kind counts and the three bool outputs' bytes
_FUSED_I32 = ("exec_idx", "time", "seq", "kind", "src", "dst", "ctx",
              "order", "rel_pos")
_FUSED_BOOL = ("exec_safe", "valid", "clean")


def _fused_outputs(A: int, m: int, n_pay: int, n_kinds: int, dev
                   ) -> tuple[FusedSelect, torch.Tensor]:
    """Fresh ``fused_select`` outputs carved from one int32 allocation: the
    fields are disjoint views (each contiguous, 4-byte aligned; the bools
    one byte an entry), so writing one never touches another."""
    am = A * m
    n_i32 = len(_FUSED_I32) * am
    words = (n_i32 + am * n_pay + A * n_kinds
             + -(-len(_FUSED_BOOL) * am // 4))
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    i32, pay, counts, rest = buf.split(
        [n_i32, am * n_pay, A * n_kinds, words - n_i32 - am * n_pay
         - A * n_kinds])
    fields = dict(zip(_FUSED_I32, i32.view(len(_FUSED_I32), A, m).unbind()))
    b8 = rest.view(torch.uint8)[:len(_FUSED_BOOL) * am].view(torch.bool)
    fields.update(zip(_FUSED_BOOL, b8.view(len(_FUSED_BOOL), A, m).unbind()))
    fields["payload"] = pay.view(torch.float32).view(A, m, n_pay)
    return FusedSelect(**fields), counts.view(A, n_kinds)


def fused_select(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                 valid, table_id, res, free_tail, exec_cap: int, *,
                 n_kinds: int, n_res: int
                 ) -> tuple[FusedSelect, torch.Tensor]:
    """The window front end over (A, cap) pools in one launch: int32
    ``time_key, seq, time, kind, src, dst, ctx, table_id, res``; bool
    ``safe, valid``; float32 ``payload`` (A, cap, P); int32 ``free_tail``
    (A,). Returns the ``FusedSelect`` of ``max(min(exec_cap, cap), 1)``
    lanes and the clean lanes' per-kind counts (A, n_kinds)."""
    _check("fused_select", time_key, seq, time, kind, src, dst, ctx,
           table_id, res)
    A, cap = time_key.shape
    _check("fused_select", safe, valid, dtype=torch.bool, shape=(A, cap))
    if payload.ndim != 3:
        raise ValueError(f"fused_select: payload must be (A, cap, P), got "
                         f"{tuple(payload.shape)}")
    n_pay = payload.shape[2]
    _check("fused_select", payload, dtype=torch.float32, shape=(A, cap, n_pay))
    _check_cursor("fused_select", free_tail, A)
    if not 1 <= n_kinds <= MAX_KINDS:
        raise ValueError(f"fused_select: n_kinds must be in [1, {MAX_KINDS}]"
                         f", got {n_kinds}")
    n_pad = _sort_pad("fused_select", cap)
    m = max(min(int(exec_cap), cap), 1)
    out, counts = _fused_outputs(A, m, n_pay, n_kinds, time_key.device)
    ins = (time_key, seq, safe, time, kind, src, dst, ctx, valid, table_id,
           res, payload, free_tail)
    _launch("fused_select", _lib().launch_fused_select, time_key,
            *map(_ptr, ins), *map(_ptr, out), _ptr(counts), A, cap, n_pad, m,
            n_pay, n_kinds, int(n_res))
    return out, counts
