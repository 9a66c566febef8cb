"""Multi-pod dry-run on a fake process group (the port of
``repro.launch.dryrun``).

For an (architecture x input-shape) cell on the single-pod (16, 16) or
multi-pod (2, 16, 16) production mesh, the reference lowers and compiles
the cell's step on 512 fake host devices and reads XLA's memory and cost
analyses.  The port's counterpart, inside the CLI's own process:

* a fake process group (``torch.testing``'s ``FakeStore``, backend
  ``fake``) of the mesh's size, which does no communication, and
  :func:`repro_torch.launch.mesh.make_production_mesh` over it;
* the rules of :func:`repro_torch.distributed.autoshard.best_rules` (or
  ``--strategy``), as the reference's ``build_cell``;
* the port's :class:`~repro_torch.models.LM` and its step (the train step
  of :mod:`repro_torch.training`, ``prefill``, ``decode_step``, or the
  encoder forward of a frontend-stub config), built under
  ``FakeTensorMode`` with the parameters, optimizer state, batch and
  cache placed as DTensors by the rules: each rank's shard of the
  ``torch.chunk`` split, the shard rank 0 holds;
* the step run once on those DTensors, whose ops DTensor propagates,
  inserting the collectives the placements need.  As the reference's
  SPMD partitioner treats a custom call, the attention and SSD kernels
  run by ``local_map`` on each rank's batch rows and heads
  (:func:`_spmd_attention`, :func:`_spmd_ssd_scan`); the reference's
  annotations of each block's attention, MLP and MoE output are applied
  (:func:`_annotated`), and gathers and row lookups along a sharded dim
  are partitioned as DTensor's embedding rule (:class:`_SpmdFunctions`).
  The rules' axes that are only used together are merged into one mesh
  dim (:func:`_placement_rules`).  These keep DTensor, which places each
  op's output by itself, from running matmuls replicated, and carry the
  dry-run on torch 2.11's DTensor as on 2.13's.

Nothing is computed, only counted.  The fake tensors sit on the host
(device type ``cpu``), so the kernel wrappers take their plain versions:
the counterpart of the reference compiling for host devices, not a
fallback.  The record has the reference's keys (``run_cell``):

* ``rules``, ``strategy``, ``chips`` and ``predicted`` from the port's
  autoshard, equal to the reference's;
* ``cost_analysis_flops``: the flops of each rank's local ops, counted with
  ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s) below
  DTensor, so per chip, as XLA's SPMD cost analysis is;
* ``cost_analysis_bytes``: the bytes each local op reads and writes (its
  tensor inputs and outputs; views move nothing), unfused, so an upper
  bound on what a fused program moves;
* ``memory_analysis``: ``argument_size_bytes``, the per-chip bytes of the
  step's arguments (parameters, optimizer state, batch, cache);
  ``output_size_bytes``, those of what it returns; ``temp_size_bytes``, the
  peak of ``torch.distributed._tools.mem_tracker.MemTracker`` over the
  step less the arguments; ``generated_code_size_bytes`` None;
* ``collectives``: ``bytes_by_kind`` / ``count_by_kind`` / ``total_bytes``
  of the functional collectives DTensor issued
  (``torch.distributed.tensor.debug.CommDebugMode``), by result bytes per
  chip as the reference sums them from the HLO;
* ``lower_s``: seconds to build and run the step under the fake modes;
  ``compile_s`` and ``hlo_bytes``: None (nothing is compiled).

The fake group lives in the process that calls :func:`init_fake_group`:
the CLI, or a test's subprocess.  Importing this module sets no
environment variable and imports nothing of ``torch.testing``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--resume]      # full sweep
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import time
import traceback
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALL_ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.distributed.autoshard import _strategy_cost, best_rules, candidate_rules, predict_cell
from repro_torch.distributed.sharding import ShardingRules, current_rules, use_rules
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch.mesh import make_production_mesh, mesh_axes, production_shape
from repro_torch.models import LM
from repro_torch.models import attention as attention_mod
from repro_torch.models import ssd as ssd_model_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.layers import map_specs, torch_dtype
from repro_torch.models.transformer import param_specs
from repro_torch.training import OptConfig, make_train_step

__all__ = ["build_cell", "init_fake_group", "run_cell", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"

# functional collectives (torch.ops._c10d_functional and the rest) by the
# reference's HLO kinds
_KINDS = (
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("permute", "collective-permute"),
)


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (this
    process is rank 0); collectives on it do nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _LocalCosts(TorchDispatchMode):
    """Flops and bytes of each rank's local ops: DTensor ops are passed to
    DTensor, which runs its local ops (and collectives) under this mode.
    The ops DTensor runs under a fake mode of its own, to propagate shapes
    at the global size, are not counted."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() not in (None, self.fake_mode):
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


class _PropagateUnfaked(TorchDispatchMode):
    """Runs each DTensor op with the ambient ``FakeTensorMode`` unset: the
    local ops still see fake tensors (their inputs are fake), while the
    small index tensors DTensor's sharding propagation makes for itself are
    real, as its ``_StridedShard`` arithmetic needs (``.tolist()``).  The
    model's own factory calls, outside DTensor ops, stay fake."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        if any(issubclass(t, DTensor) for t in types):
            with unset_fake_temporarily():
                return func(*args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


def _comm_bytes_mode():
    """A ``CommDebugMode`` that also sums each collective's result bytes by
    the reference's kind names."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes_by_kind: dict[str, float] = defaultdict(float)
            self.count_by_kind: dict[str, int] = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
                return out
            packet = func._overloadpacket
            if packet in self.comm_registry or "c10d" in str(packet):
                name = str(packet).lower()
                kind = next((k for key, k in _KINDS if key in name), None)
                if kind is not None:
                    self.bytes_by_kind[kind] += sum(_nbytes(t) for t in _tensors(out))
                    self.count_by_kind[kind] += 1
            return out

    return _CommBytes()


def _place(full: torch.Tensor, mesh, placements) -> DTensor:
    """Rank 0's shard of ``full`` (torch.chunk along each sharded dim, as
    DTensor splits), wrapped as a DTensor of ``full``'s global shape."""
    local = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = torch.chunk(local, mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


def _place_model(model: LM, rules) -> None:
    """Replace every parameter of ``model`` by its DTensor placed by the
    rules: a layer's parameter is a slice of the reference's stacked leaf,
    its axes those of the leaf without ``layers``."""
    axes_tree = map_specs(lambda s: s.axes, param_specs(model.cfg))
    for name, (path, r) in model._reference_paths().items():
        axes = axes_tree
        for k in path:
            axes = axes[k]
        if r is not None:
            axes = axes[1:]
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        full = getattr(mod, leaf).detach()
        setattr(mod, leaf, torch.nn.Parameter(_place(full, rules.mesh, rules.sharding_for(axes)), requires_grad=False))


def _batch(cfg, cell, rules) -> dict:
    B, S = cell.global_batch, cell.seq_len
    place = lambda t, axes: _place(t, rules.mesh, rules.sharding_for(axes))  # noqa: E731
    labels = place(torch.zeros((B, S), dtype=torch.int32), ("batch", "seq"))
    if cfg.frontend_stub:
        embeds = torch.zeros((B, S, cfg.d_model), dtype=torch_dtype(cfg.dtype))
        return {"embeds": place(embeds, ("batch", "seq", None)), "labels": labels}
    return {"tokens": place(torch.zeros((B, S), dtype=torch.int32), ("batch", "seq")), "labels": labels}


def _opt_state(model: LM) -> dict:
    """AdamW's state (``training.optimizer.adamw_init``) with each moment
    and master copy placed as its parameter is."""
    params = dict(model.named_parameters())
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {
        "m": {k: f32(p) for k, p in params.items()},
        "v": {k: f32(p) for k, p in params.items()},
        "master": {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def _cache(model: LM, batch: int, max_len: int, rules) -> dict:
    axes = model.cache_axes()
    return {
        s: {b: {k: _place(t, rules.mesh, rules.sharding_for(axes[s][b][k])) for k, t in leaves.items()}
            for b, leaves in blocks.items()}
        for s, blocks in model.init_cache(batch, max_len).items()
    }


def _joint_axes(rules) -> list[tuple[str, ...]]:
    """Groups of mesh axes the rules only ever use together: each tuple value
    of the table whose axes no other value uses apart from the rest."""
    values = [v for v in rules.table.values() if v is not None]
    sets = [frozenset((v,) if isinstance(v, str) else v) for v in values]
    groups = []
    for g in {s for s in sets if len(s) > 1}:
        if all(s == g or not (s & g) for s in sets):
            groups.append(g)
    order = list(mesh_axes(rules.mesh))
    return [tuple(a for a in order if a in g) for g in groups]


def _placement_rules(rules):
    """The rules the dry-run places tensors by.  DTensor before torch 2.13
    propagates a dim sharded over two mesh dims (``[Shard(d), Shard(d)]``)
    through few ops; where the rules use axes only together (ZeRO-3's
    ``batch`` and ``embed`` over ("data", "model"), a pod's ``batch`` over
    ("pod", "data")), the tensors are placed on a mesh where those axes
    are one dim of their product's size: the same shard on every chip."""
    groups = _joint_axes(rules)
    if not groups:
        return rules
    axes = mesh_axes(rules.mesh)
    merged = {a: "_".join(g) for g in groups for a in g}
    names, shape = [], []
    for a, n in axes.items():
        name = merged.get(a, a)
        if names and names[-1] == name:
            shape[-1] *= n
        else:
            names.append(name)
            shape.append(n)
    if len(names) != len(set(names)):
        return rules  # a group's axes are not adjacent on the mesh
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the mesh's rank tensor is real
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    table = {k: v if v is None or isinstance(v, str) else
             ("_".join(a for a in axes if a in v) if frozenset(v) in {frozenset(g) for g in groups} else v)
             for k, v in rules.table.items()}
    return ShardingRules(mesh, table)


def _spmd_attention(q, k, v, *, causal=True, q_offset=0, window=None):
    """Attention partitioned as the reference's SPMD partitioner treats a
    kernel: each rank runs the kernel's plain version on its own batch rows
    and query heads.  The KV heads are expanded to the query heads (each
    rank then takes the ones its query heads read); sequence and head dims
    stay whole on every rank."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if KV != H:
        g = H // KV
        k = k[:, :, None].expand(B, KV, g, Sk, D).reshape(B, H, Sk, D)
        v = v[:, :, None].expand(B, KV, g, Sk, D).reshape(B, H, Sk, D)
    pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate() for p in q.placements]
    plain = functools.partial(flash_attention_plain, causal=causal, q_offset=q_offset, window=window)
    return local_map(plain, out_placements=pl, in_placements=(pl, pl, pl), device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _spmd_ssd_scan(xb, a, Bm, Cm):
    """The SSD scan partitioned as a kernel: each rank runs the plain
    version on its own batch rows and heads (``Bm``, ``Cm`` have no head
    dim: whole on the ranks that split heads)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate() for p in xb.placements]
    pl_bc = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    # a rank that holds some heads holds part of Bm's and Cm's gradient
    grad_bc = [Partial() if isinstance(p, Shard) and p.dim == 1 else q for p, q in zip(pl, pl_bc)]
    return local_map(ssd_scan_plain, out_placements=(pl, pl), in_placements=(pl, pl, pl_bc, pl_bc),
                     in_grad_placements=(pl, pl, grad_bc, grad_bc), device_mesh=xb.device_mesh,
                     redistribute_inputs=True)(xb, a, Bm, Cm)


def _sharded_gather(x, dim: int, index):
    """``x.gather(dim, index)`` with ``x`` sharded along ``dim`` (the
    vocabulary of vocab-parallel logits): each rank gathers the indices in
    its own slice and zeros the rest, and the result is the sum over the
    ranks (an all-reduce), as DTensor's masked embedding lookup is."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    dim = dim % x.ndim
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    in_x = list(x.placements)
    in_index = [Replicate() if i in split else p for i, p in enumerate(x.placements)]
    out = [Partial() if i in split else p for i, p in enumerate(x.placements)]
    size = x.shape[dim]
    offset = 0
    for i in split:  # torch.chunk's slices, mesh dim after mesh dim
        chunk = -(-size // mesh.size(i))
        offset += coord[i] * chunk
        size = chunk

    def local(xl, il):
        rel = il - offset
        inside = (rel >= 0) & (rel < xl.shape[dim])
        got = xl.gather(dim, rel.clamp(0, max(xl.shape[dim] - 1, 0)))
        return torch.where(inside, got, torch.zeros_like(got))

    got = local_map(local, out_placements=out, in_placements=(in_x, in_index), device_mesh=mesh,
                    redistribute_inputs=True)(x, index)
    return got.redistribute(mesh, in_index)  # the sum, where the next op needs it (an all-reduce)


def _row_lookup(table, index):
    """``table[index]`` (an embedding lookup) partitioned as DTensor's
    embedding rule: on a mesh dim that splits the index the table is
    gathered whole (FSDP's all-gather); on one that splits the table's rows
    (vocab-parallel) each rank looks up the indices in its own rows, zeros
    the rest, and the result is their sum (an all-reduce).  The table's
    gradient is each rank's part: ``Partial`` where the index is split."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    coord = mesh.get_coordinate()
    idx_pl = list(index.placements)
    tab_pl, out_pl, grad_pl = [], [], []
    rows, offset = table.shape[0], 0
    for i, (t, x) in enumerate(zip(table.placements, idx_pl)):
        if isinstance(t, Shard) and t.dim == 0 and not isinstance(x, Shard):
            chunk = -(-rows // mesh.size(i))
            offset += coord[i] * chunk
            rows = chunk
            tab_pl.append(t)
            out_pl.append(Partial())
            grad_pl.append(t)
        else:
            tab_pl.append(Replicate())
            out_pl.append(x)
            grad_pl.append(Partial() if isinstance(x, Shard) else Replicate())

    def local(tl, il):
        rel = il.long() - offset
        inside = (rel >= 0) & (rel < tl.shape[0])
        got = tl[rel.clamp(0, max(tl.shape[0] - 1, 0))]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    got = local_map(local, out_placements=out_pl, in_placements=(tab_pl, idx_pl),
                    in_grad_placements=(grad_pl, idx_pl), device_mesh=mesh, redistribute_inputs=True)(table, index)
    return got.redistribute(mesh, idx_pl)  # the sum, where the next op needs it (an all-reduce)


class _SpmdFunctions(torch.overrides.TorchFunctionMode):
    """``gather`` along a sharded dim through :func:`_sharded_gather`, and
    row lookups (``table[index]``) through :func:`_row_lookup`: DTensor
    before torch 2.13 has no working rule for either."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.gather, torch.gather) and isinstance(args[0], DTensor) and not kwargs:
            x, dim, index = args[:3]
            if any(p.is_partial() for p in x.placements):  # the sum first (an all-reduce)
                x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])
            if any(isinstance(p, Shard) and p.dim == dim % x.ndim for p in x.placements):
                return _sharded_gather(x, dim, index)
            return func(x, dim, index)
        if (func is torch.Tensor.__getitem__ and isinstance(args[0], DTensor) and isinstance(args[1], DTensor)
                and not args[1].is_floating_point() and args[1].dtype != torch.bool):
            return _row_lookup(*args)
        return func(*args, **kwargs)


class _Annotate(torch.autograd.Function):
    """``y`` placed as the rules place (batch, seq, embed), the reference's
    ``constrain``: a partial sum is all-reduced.  Its gradient keeps those
    placements, a partial one becoming whole (the all-reduce's transpose
    in GSPMD), where DTensor's own backward of a redistribution hands back
    a partial gradient that the next matmuls can only meet replicated."""

    @staticmethod
    def forward(ctx, y):
        placements = current_rules().sharding_for(("batch", "seq", None))
        ctx.placements = [Replicate() if p.is_partial() else p for p in y.placements]
        return y.redistribute(y.device_mesh, placements)

    @staticmethod
    def backward(ctx, dy):
        return dy.redistribute(dy.device_mesh, ctx.placements)


def _annotated(fn):
    """``fn`` (the attention, MLP or MoE half of a block) with its output
    placed as the reference annotates it (``constrain(y, "batch", "seq",
    None)``, :class:`_Annotate`): the residual contribution summed over the
    model axis where it is made.  DTensor places each op's output by
    itself, op by op; without the reference's annotation it may split the
    residual stream's tokens over the model axis and then run the next
    matmuls replicated."""

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            return (_Annotate.apply(out[0]), *out[1:])
        return _Annotate.apply(out)

    return call


_HOOKS = (  # (module, name, its counterpart in the dry-run)
    (attention_mod, "flash_attention", lambda f: _spmd_attention),
    (ssd_model_mod, "ssd_scan", lambda f: _spmd_ssd_scan),
    (transformer_mod, "attention_kv", _annotated),
    (transformer_mod, "mlp", _annotated),
    (transformer_mod, "moe_ffn", _annotated),
)


@contextlib.contextmanager
def _spmd_kernels(rules):
    """For the block: the model's kernels partitioned as the reference's
    SPMD partitioner treats a custom call (:func:`_spmd_attention`,
    :func:`_spmd_ssd_scan`); the reference's annotations of each block's
    attention, MLP and MoE output (:func:`_annotated`, under ``rules``);
    gathers and row lookups through :class:`_SpmdFunctions`."""
    prev = [getattr(mod, name) for mod, name, _ in _HOOKS]
    for (mod, name, hook), fn in zip(_HOOKS, prev):
        setattr(mod, name, hook(fn))
    try:
        with use_rules(rules), _SpmdFunctions():
            yield
    finally:
        for (mod, name, _), fn in zip(_HOOKS, prev):
            setattr(mod, name, fn)


def build_cell(
    arch: str,
    shape: str,
    mesh,
    strategy: str | None = None,
    depth_override: int | None = None,
    remat_override: str | None = None,
    overrides: dict | None = None,
):
    """The cell's step and its placed arguments, built under the caller's
    ``FakeTensorMode``: ``(fn, args, model, rules, placing, strategy,
    cost, cfg, cell)``; ``fn(*args)`` runs the step.  ``rules`` are
    autoshard's on ``mesh``; the tensors are placed by ``placing``,
    :func:`_placement_rules` of them."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if depth_override is not None:
        # the roofline's depth-extrapolation protocol (the reference lowers
        # unrolled depth-p and depth-2p programs; the port's layers are a
        # Python loop, unrolled already)
        cfg = cfg.replace(n_layers=depth_override, scan_layers=False)
    if remat_override is not None:
        cfg = cfg.replace(remat=remat_override)
    cell = SHAPES[shape]
    if strategy is None:
        sname, rules, cost = best_rules(cfg, mesh, global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind)
    else:
        cands = candidate_rules(cfg, mesh, global_batch=cell.global_batch, seq=cell.seq_len)
        sname, rules = strategy, cands[strategy]
        cost = _strategy_cost(strategy, cfg, rules, global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind)

    placing = _placement_rules(rules)
    model = LM(cfg, device="cpu")
    _place_model(model, placing)
    if cell.kind == "train":
        fn = make_train_step(model, OptConfig())
        args = (_opt_state(model), _batch(cfg, cell, placing))
    elif cell.kind == "prefill":
        batch = _batch(cfg, cell, placing)
        if not cfg.decoder:  # encoder-only: "prefill" = full encode
            fn = lambda b: model.forward(b.get("tokens"), embeds=b.get("embeds"))[0]  # noqa: E731
            args = ({k: v for k, v in batch.items() if k != "labels"},)
        else:
            fn = model.prefill
            args = (batch["tokens"],)
    else:  # decode: one new token against a seq_len cache
        fn = model.decode_step
        tokens = _place(torch.zeros((cell.global_batch,), dtype=torch.int32), placing.mesh,
                        placing.sharding_for(("batch",)))
        args = (_cache(model, cell.global_batch, cell.seq_len, placing), tokens, torch.zeros((), dtype=torch.int32))
    return fn, args, model, rules, placing, sname, cost, cfg, cell


def run_cell(
    arch: str,
    shape: str,
    mesh_kind: str,
    strategy: str | None = None,
    depth_override: int | None = None,
    remat_override: str | None = None,
    overrides: dict | None = None,
    *,
    mesh=None,
) -> dict:
    """One cell's record, on ``mesh`` (default: the production mesh of
    ``mesh_kind`` over this process's fake group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
        fn, args, model, rules, placing, sname, cost, cfg, cell = build_cell(
            arch, shape, mesh, strategy, depth_override, remat_override, overrides
        )
        arg_tensors = [p for p in model.parameters()] + _tensors(args)
        arg_bytes = sum(_nbytes(t) for t in arg_tensors)
        costs, comm, mem = _LocalCosts(fake_mode), _comm_bytes_mode(), MemTracker()
        mem.track_external(model, *[_local(t) for t in _tensors(args)])
        with contextlib.ExitStack() as stack:
            for ctx in (_spmd_kernels(placing), implicit_replication(), mem):
                stack.enter_context(ctx)
            # MemTracker keeps the ops run under the fake mode current at its
            # entry; the local ops of DTensor ops run with it unset
            # (_PropagateUnfaked), outside any fake mode
            mem._fake_mode_on_entry = None
            for ctx in (costs, comm, _PropagateUnfaked()):
                stack.enter_context(ctx)
            out = fn(*args)
        t_trace = time.time() - t0
        peak = mem.get_tracker_snapshot("peak")
        peak_bytes = max((d.get("Total", 0) for d in peak.values()), default=0)
        out_bytes = sum(_nbytes(t) for t in _tensors(out))

    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "chips": int(mesh.size()),
        "n_layers": cfg.n_layers,
        "depth_override": depth_override,
        "remat": cfg.remat,
        "strategy": sname,
        "rules": {k: v for k, v in rules.table.items()},
        "status": "ok",
        "lower_s": round(t_trace, 2),
        "compile_s": None,
        "memory_analysis": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": max(peak_bytes - arg_bytes, 0),
            "generated_code_size_bytes": None,
        },
        "cost_analysis_flops": float(costs.flops),
        "cost_analysis_bytes": float(costs.bytes),
        "cost_analysis": {"flops": float(costs.flops), "bytes accessed": float(costs.bytes)},
        "collectives": {
            "bytes_by_kind": dict(comm.bytes_by_kind),
            "count_by_kind": dict(comm.count_by_kind),
            "total_bytes": float(sum(comm.bytes_by_kind.values())),
        },
        "hlo_bytes": None,
        "model_params": cfg.n_params(),
        "model_active_params": cfg.n_active_params(),
        "tokens": cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1),
        "kind": cell.kind,
        "predicted": {
            "strategy_cost": {
                "compute_s": cost.compute_s,
                "memory_s": cost.memory_s,
                "collective_s": cost.collective_s,
                "bound": cost.bound,
            },
            "candidates": predict_cell(
                get_config(arch), mesh, global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind
            ),
        },
    }
    return rec


@contextlib.contextmanager
def fake_group(mesh_kind: str):
    """A fake process group of the production mesh's size for the block."""
    shape, _ = production_shape(mesh_kind == "multi")
    init_fake_group(math.prod(shape))
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)

    cells: list[tuple[str, str, str]] = []
    if args.all:
        for arch in ALL_ARCHS:
            cfg = get_config(arch)
            for shape in SHAPES:
                ok, why = cell_applicable(cfg, shape)
                if not ok:
                    skip = {"arch": arch, "shape": shape, "status": "skip", "reason": why}
                    for mesh in ("single", "multi"):
                        p = OUT_DIR / f"{arch}__{shape}__{mesh}.json"
                        p.write_text(json.dumps({**skip, "mesh": mesh}, indent=1))
                    continue
                cells.append((arch, shape, "single"))
                cells.append((arch, shape, "multi"))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, args.mesh)]

    for arch, shape, mesh in cells:
        tag = f"__{args.tag}" if args.tag else ""
        out = OUT_DIR / f"{arch}__{shape}__{mesh}{tag}.json"
        if args.resume and out.exists() and json.loads(out.read_text()).get("status") == "ok":
            print(f"[skip] {out.name}")
            continue
        print(f"[cell] {arch} x {shape} x {mesh} ...", flush=True)
        t0 = time.time()
        try:
            with fake_group(mesh):
                rec = run_cell(arch, shape, mesh, args.strategy)
            print(
                f"  ok in {time.time()-t0:.1f}s  flops={rec['cost_analysis_flops']}"
                f" coll={rec['collectives']['total_bytes']:.3g}B strat={rec['strategy']}",
                flush=True,
            )
        except Exception as e:  # a cell that fails to trace is recorded, as the reference's sweep records it
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"  ERROR {type(e).__name__}: {str(e)[:200]}", flush=True)
        out.write_text(json.dumps(rec, indent=1, default=str))
        gc.collect()


if __name__ == "__main__":
    main()
