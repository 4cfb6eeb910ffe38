"""AdamW with torch semantics and per-object-slot step counts.

Port of ``openobj_tpu.core.optim``. ``torch.optim.AdamW`` keeps one step
count per tensor; a stacked [O, ...] parameter needs one per slot, so the
update is written out here:

  * decoupled decay applied before the step, p *= 1 - lr*wd;
  * m/v bias correction uses a per-slot count (``count [O]`` for stacked
    fg leaves, a scalar for the bg model);
  * an ``active`` [O] mask freezes dead slots entirely: their params, m and
    v come out bit-identical;
  * ``reset_slot`` zeroes a slot's m/v/count when a new object is allocated;
  * the PE ``scale`` leaf (a constant) is excluded by name.

``adamw_update_flat`` is the same step over every trainable leaf at once,
as the JAX package's ``adamw_update_flat`` (the trainer's
``optim_impl="flat"``): on a CUDA device one launch of the hand-written
kernel in ``csrc/adamw_flat.cu``, on the CPU its plain version
``adamw_update_flat_plain`` (concatenate, update, split back). Every
version returns new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from openobj_torch.models.object_field import tree_map

# launches of the flat AdamW kernel, as a plain int
COUNTS = {"adamw_flat": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass
class AdamWState:
    mu: dict
    nu: dict
    count: torch.Tensor  # [O] int32 for stacked params, [] for single models


def flatten_with_path(tree: dict, prefix: tuple = ()):
    """[(path tuple of keys, leaf)] in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(flatten_with_path(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def trainable(path: tuple) -> bool:
    return "scale" not in path


def init_adamw_state(params: dict, n_slots: int | None = None) -> AdamWState:
    dev = flatten_with_path(params)[0][1].device
    count = torch.zeros((n_slots,) if n_slots is not None else (),
                        dtype=torch.int32, device=dev)
    return AdamWState(
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
        count=count,
    )


def set_path(tree: dict, path: tuple, value) -> None:
    """tree[path[0]]...[path[-1]] = value, creating inner dicts."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def unflatten(pairs) -> dict:
    """Inverse of ``flatten_with_path``."""
    out = {}
    for path, x in pairs:
        set_path(out, path, x)
    return out


def _copy_structure(tree: dict) -> dict:
    return {k: _copy_structure(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


@torch.no_grad()
def adamw_update(
    params: dict,
    grads: dict,
    state: AdamWState,
    lr: float,
    weight_decay: float,
    active: torch.Tensor | None = None,  # [O] bool for stacked params
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[dict, AdamWState]:
    """One AdamW step; returns new (params, state) and leaves the inputs
    unchanged. ``grads`` mirrors ``params``; a missing or None leaf counts
    as a zero gradient. For stacked params pass ``active`` to gate slots."""
    new_count, bc1, bc2 = _bias_corrections(state, active, b1, b2)

    def expand(v, leaf):
        return v if v.ndim == 0 else v.reshape(v.shape + (1,) * (leaf.ndim - 1))

    new = []
    for path, p, g, m, v in _trainable_leaves(params, grads, state):
        if g is None:
            g = torch.zeros_like(p)
        m_n = b1 * m + (1.0 - b1) * g
        v_n = b2 * v + (1.0 - b2) * g * g
        m_hat = m_n / expand(bc1, p)
        v_hat = v_n / expand(bc2, p)
        p_n = p * (1.0 - lr * weight_decay)
        p_n = p_n - lr * m_hat / (torch.sqrt(v_hat) + eps)
        if active is not None:
            gate = expand(active, p)
            p_n = torch.where(gate, p_n, p)
            m_n = torch.where(gate, m_n, m)
            v_n = torch.where(gate, v_n, v)
        new.append((path, p_n, m_n, v_n))
    return _with_leaves(state, params, new, new_count)


def _bias_corrections(state: AdamWState, active, b1: float, b2: float):
    """(new count, bc1, bc2) of a step: the count moves by ``active`` (by 1
    without it), and each correction is 1 - b^max(t, 1) of the new count."""
    if active is not None:
        new_count = state.count + active.to(torch.int32)
    else:
        new_count = state.count + 1
    t = torch.clamp(new_count.to(torch.float32), min=1.0)
    return new_count, 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def _trainable_leaves(params: dict, grads: dict, state: AdamWState):
    """[(path, p, g or None, m, v)] of the trainable leaves, in key order."""
    g_flat = dict(flatten_with_path(grads))
    m_flat = dict(flatten_with_path(state.mu))
    v_flat = dict(flatten_with_path(state.nu))
    return [(path, p, g_flat.get(path), m_flat[path], v_flat[path])
            for path, p in flatten_with_path(params) if trainable(path)]


def _with_leaves(state: AdamWState, params: dict, new: list, new_count) -> tuple:
    """The trees of ``params`` and ``state`` with ``new``'s (path, p, m, v)
    in place of their leaves; the other leaves (the PE scale) as they were."""
    new_p, new_m, new_v = (_copy_structure(params), _copy_structure(state.mu),
                           _copy_structure(state.nu))
    for path, p, m, v in new:
        set_path(new_p, path, p)
        set_path(new_m, path, m)
        set_path(new_v, path, v)
    return new_p, AdamWState(mu=new_m, nu=new_v, count=new_count)


@torch.no_grad()
def adamw_update_flat_plain(
    params: dict,
    grads: dict,
    state: AdamWState,
    lr: float,
    weight_decay: float,
    active: torch.Tensor | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[dict, AdamWState]:
    """The flat update's plain version, the JAX ``adamw_update_flat``: every
    trainable leaf viewed as [O, -1] (stacked, with ``active``) or [-1]
    (the unstacked bg model) and concatenated, the AdamW arithmetic run once
    on the whole matrix with the per-slot corrections and gate broadcast
    down its rows, and the result split back into leaves of their own.
    Each element sees the operations of ``adamw_update`` in their order, so
    the two agree bit for bit."""
    stacked = active is not None
    new_count, bc1, bc2 = _bias_corrections(state, active, b1, b2)
    leaves = _trainable_leaves(params, grads, state)

    def flat(x):
        return x.reshape(x.shape[0], -1) if stacked else x.reshape(-1)

    ax = 1 if stacked else 0
    p_all = torch.cat([flat(p) for _, p, _, _, _ in leaves], dim=ax)
    g_all = torch.cat([flat(torch.zeros_like(p) if g is None else g)
                       for _, p, g, _, _ in leaves], dim=ax)
    m_all = torch.cat([flat(m) for _, _, _, m, _ in leaves], dim=ax)
    v_all = torch.cat([flat(v) for _, _, _, _, v in leaves], dim=ax)
    if stacked:
        bc1, bc2 = bc1[:, None], bc2[:, None]
    m_new = b1 * m_all + (1.0 - b1) * g_all
    v_new = b2 * v_all + (1.0 - b2) * g_all * g_all
    p_new = p_all * (1.0 - lr * weight_decay)
    p_new = p_new - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if stacked:
        gate = active[:, None]
        p_new = torch.where(gate, p_new, p_all)
        m_new = torch.where(gate, m_new, m_all)
        v_new = torch.where(gate, v_new, v_all)

    new, at = [], 0
    for path, p, _, _, _ in leaves:
        k = p[0].numel() if stacked else p.numel()

        def leaf(x):
            x = x[:, at:at + k] if stacked else x[at:at + k]
            return x.reshape(p.shape).clone(memory_format=torch.contiguous_format)

        new.append((path, leaf(p_new), leaf(m_new), leaf(v_new)))
        at += k
    return _with_leaves(state, params, new, new_count)


_VP = ctypes.c_void_p
_F = ctypes.c_float


def typed(lib):
    """``lib`` (a build of ``csrc/adamw_flat.cu``) with its entry points typed."""
    if not getattr(lib, "_openobj_typed", False):
        lib.af_max_leaves.argtypes = []
        lib.af_max_leaves.restype = ctypes.c_int
        lib.af_update.argtypes = ([_VP, _VP, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP]
                                  + [_F] * 7 + [_VP])
        lib.af_update.restype = ctypes.c_int
        lib._openobj_typed = True
    return lib


def _lib():
    """The loaded, typed library of ``csrc/adamw_flat.cu``."""
    from openobj_torch import kernels

    return typed(kernels.load("adamw_flat"))


def _grad_layout(g: torch.Tensor, stacked: bool) -> tuple[int, int, int, int]:
    """(slot stride, columns, row stride, column stride) of a gradient leaf,
    in elements, each slot a vector or a matrix: a view into a packed
    gradient as autograd leaves it (slices, transposes) or a tensor of its
    own."""
    x = g[0] if stacked else g
    if x.dim() == 2:
        cols, rs, cs = x.shape[1], x.stride(0), x.stride(1)
    elif x.dim() == 1:
        cols, cs = x.shape[0], x.stride(0)
        rs = cols * cs
    else:
        raise ValueError(f"adamw_update_flat: a gradient leaf of shape {tuple(g.shape)}: a "
                         "slot of other than 1 or 2 dimensions")
    return (g.stride(0) if stacked else 0), cols, rs, cs


def flat_launch(lib, leaves: list, count: torch.Tensor, active: torch.Tensor | None,
                lr: float, weight_decay: float, b1: float, b2: float, eps: float,
                stream) -> tuple[list, torch.Tensor]:
    """Launch ``af_update`` of ``lib`` on ``leaves`` ([(path, p, g or None,
    m, v)], as ``_trainable_leaves`` gives them) into fresh outputs; returns
    ([(path, p', m', v')], new count). The caller checks the tensors."""
    stacked = active is not None
    n_slots = count.shape[0] if stacked else 1
    ptrs = (_VP * (7 * len(leaves)))()
    sizes = (ctypes.c_longlong * (5 * len(leaves)))()
    new = []
    for i, (path, p, g, m, v) in enumerate(leaves):
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        ptrs[7 * i:7 * i + 7] = [p.data_ptr(), None if g is None else g.data_ptr(),
                                 m.data_ptr(), v.data_ptr(), *(x.data_ptr() for x in out)]
        layout = (0, 1, 0, 0) if g is None else _grad_layout(g, stacked)
        sizes[5 * i:5 * i + 5] = [p.numel() // n_slots, *layout]
        new.append((path, *out))
    new_count = torch.empty_like(count)
    err = lib.af_update(ptrs, sizes, len(leaves), n_slots, count.data_ptr(),
                        new_count.data_ptr(), active.data_ptr() if stacked else None,
                        b1, 1.0 - b1, b2, 1.0 - b2, lr, eps, 1.0 - lr * weight_decay, stream)
    if err != 0:
        raise RuntimeError(f"adamw_update_flat: CUDA error {err} at launch")
    return new, new_count


@torch.no_grad()
def adamw_update_flat_cuda(
    params: dict,
    grads: dict,
    state: AdamWState,
    lr: float,
    weight_decay: float,
    active: torch.Tensor | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[dict, AdamWState]:
    """The flat update as one launch of ``adamw_flat_kernel``
    (``csrc/adamw_flat.cu``) on CUDA tensors: the leaves' pointers go to the
    kernel in its launch parameter, and it writes fresh p, m, v and count."""
    stacked = active is not None
    leaves = _trainable_leaves(params, grads, state)
    count = state.count
    n_slots = count.shape[0] if stacked else 1
    lib = _lib()
    if not 0 < len(leaves) <= lib.af_max_leaves():
        raise ValueError(f"adamw_update_flat: {len(leaves)} trainable leaves, the kernel takes "
                         f"1 to {lib.af_max_leaves()}")
    dev = count.device
    if not count.is_cuda or count.dtype != torch.int32 or not count.is_contiguous() \
            or count.shape != ((n_slots,) if stacked else ()):
        raise ValueError(f"adamw_update_flat: count {count.dtype} {tuple(count.shape)} on "
                         f"{count.device}, expected a contiguous int32 CUDA tensor")
    if stacked and (active.device != dev or active.dtype != torch.bool
                    or active.shape != (n_slots,) or not active.is_contiguous()):
        raise ValueError(f"adamw_update_flat: active {active.dtype} {tuple(active.shape)} on "
                         f"{active.device}, expected [{n_slots}] bool on {dev}")
    for path, p, g, m, v in leaves:
        for name, x in (("param", p), ("gradient", g), ("first moment", m),
                        ("second moment", v)):
            if x is None:
                continue
            if x.device != dev or x.dtype != torch.float32 or x.shape != p.shape:
                raise ValueError(f"adamw_update_flat: {name} {path} is {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}, expected float32 "
                                 f"{tuple(p.shape)} on {dev}")
            if x is not g and not x.is_contiguous():
                raise ValueError(f"adamw_update_flat: {name} {path} is not contiguous")
        if stacked and p.shape[0] != n_slots:
            raise ValueError(f"adamw_update_flat: {path} has {p.shape[0]} slots, count {n_slots}")
    new, new_count = flat_launch(lib, leaves, count, active, lr, weight_decay, b1, b2, eps,
                                 torch.cuda.current_stream(dev).cuda_stream)
    COUNTS["adamw_flat"] += 1
    return _with_leaves(state, params, new, new_count)


def adamw_update_flat(params: dict, grads: dict, state: AdamWState, lr: float,
                      weight_decay: float, active: torch.Tensor | None = None,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``adamw_update`` as one flat update (the JAX ``adamw_update_flat``):
    the kernel on a CUDA state, its plain version on a CPU one."""
    run = adamw_update_flat_cuda if state.count.is_cuda else adamw_update_flat_plain
    return run(params, grads, state, lr, weight_decay, active, b1, b2, eps)


@torch.no_grad()
def reset_slot(state: AdamWState, slot: int) -> AdamWState:
    """Zero a slot's optimizer state (fresh object in a reused slot)."""
    def zero_slot(x):
        x = x.clone()
        x[slot] = 0
        return x
    return AdamWState(mu=tree_map(zero_slot, state.mu),
                      nu=tree_map(zero_slot, state.nu),
                      count=zero_slot(state.count))
