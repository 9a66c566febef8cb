"""Lowering: MappedGraph -> CompiledModel (paper Sec. IV-C "code gen").

The port of ``repro.backend.lower``.  Each
:class:`~repro_torch.core.dispatcher.MappedSegment` becomes ONE fused
executor, a Python function over tensors on the model's device:

* **conv / dwconv anchors** (route ``tiled_conv``): the winning LOMA OY
  tile is the segment's output-row stripe (the L1-resident band,
  ``meta["block_oy"]``).  An int8 anchor (``elem_bytes == 1``) whose chain
  is exactly [bias_add,] plain-shift requant[, relu] runs the hand-written
  Hopper conv :func:`repro_torch.kernels.conv_requant.conv_requant`, with
  the epilogue in registers, in one launch per segment
  (``meta["kernel"] == "conv_requant"``); any other conv segment runs the
  banded conv of :mod:`repro_torch.kernels.tiled_conv` with its chain
  through the op library (``meta["kernel"] == "banded"``).
* **int8 dense anchors with a plain-shift requant epilogue** (route
  ``pallas_gemm``, the reference's name kept so ``routes()`` compare key
  for key) run the hand-written Hopper int8 GEMM through its segment
  entry :func:`repro_torch.kernels.matmul_requant.matmul_requant_f32`
  with ``rounding="even"``, which reproduces the interpreter's
  round-half-to-even requant bit-exactly, in one launch per segment.  In
  this package ``pallas_gemm`` *is* the CUDA kernel.
* **everything else** (elementwise chains, pools, structural ops, CPU
  fallback segments) evaluates through the op library shared with the
  interpreter (``repro_torch.cnn.execute.apply_node``).

Schedules reach the executors via
:func:`repro_torch.core.schedule.schedule_from_result` — lowering never
re-runs the DSE.  The DSE's GEMM block sizes are kept in
``LoweredSegment.meta``; the CUDA kernel picks its own tiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.cnn.execute import apply_node
from repro_torch.core import (
    KernelSchedule,
    MappedGraph,
    MappedSegment,
    MatchTarget,
    Node,
    schedule_from_result,
)
from repro_torch.kernels.conv_requant import conv_requant
from repro_torch.kernels.conv_requant import supports as conv_supports
from repro_torch.kernels.matmul_requant import matmul_requant_f32
from repro_torch.kernels.tiled_conv import tiled_conv2d

from .memory import plan_memory
from .runtime import CompiledModel

__all__ = ["lower", "LoweredSegment", "LoweringError"]


class LoweringError(RuntimeError):
    """The mapped graph cannot be lowered to segment executors."""


@dataclass
class LoweredSegment:
    """One fused executor for one mapped segment."""

    index: int
    segment: MappedSegment
    route: str  # "tiled_conv" | "pallas_gemm" | "reference" | "structural"
    input_names: tuple[str, ...]
    output_name: str
    fn: Callable  # fn(seg_params: dict, *inputs) -> output tensor
    kernel_schedule: KernelSchedule | None = None
    meta: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.segment.anchor.name

    @property
    def module(self) -> str:
        return self.segment.module

    def params_slice(self, params: dict) -> dict:
        return {n.name: params.get(n.name, {}) for n in self.segment.nodes}


# ---------------------------------------------------------------------------
# Fused executors
# ---------------------------------------------------------------------------


def _fused_reference_fn(
    nodes: Sequence[Node],
    input_names: tuple[str, ...],
    output_name: str,
    anchor_impl: Callable | None = None,
    lane: str | None = None,
):
    """One function evaluating the whole segment chain through the shared
    op library (bit-exact with the interpreter by construction).
    ``anchor_impl(params, *xs)`` overrides the first node's evaluation —
    that is how the banded conv slots in under the same epilogue.  With
    tracing on, each node is a span ``node:<op>`` on ``lane`` carrying the
    node's name: on the card it covers the node's launches, which is how
    a device trace splits a segment's kernels into anchor and epilogue."""
    span_names = [f"node:{nd.op}" for nd in nodes]
    span_attrs = [{"name": nd.name} for nd in nodes]

    def fn(seg_params: dict, *xs):
        env = dict(zip(input_names, xs))
        tr = obs.get_tracer()
        if tr.enabled:
            return traced(tr, seg_params, env)
        for i, nd in enumerate(nodes):
            args = [env[k] for k in nd.inputs]
            p = seg_params.get(nd.name, {})
            if i == 0 and anchor_impl is not None:
                env[nd.name] = anchor_impl(p, *args)
            else:
                env[nd.name] = apply_node(nd, p, args)
        return env[output_name]

    def traced(tr, seg_params: dict, env: dict):
        for i, nd in enumerate(nodes):
            t0 = tr.now_us()
            args = [env[k] for k in nd.inputs]
            p = seg_params.get(nd.name, {})
            if i == 0 and anchor_impl is not None:
                env[nd.name] = anchor_impl(p, *args)
            else:
                env[nd.name] = apply_node(nd, p, args)
            tr.complete(span_names[i], t0, cat="runtime", lane=lane, attrs=span_attrs[i])
        return env[output_name]

    return fn


def _tiled_conv_impl(anchor: Node, ksched: KernelSchedule | None):
    """Anchor override running the banded conv with the winning schedule's
    OY tile as the band size (one whole-array band without a schedule)."""
    stride = int(anchor.attr("stride", 1) or 1)
    depthwise = anchor.op == "dwconv2d"
    oy = int(anchor.attr("OY", 1) or 1)
    block_oy = oy
    if ksched is not None:
        block_oy = max(1, min(int(ksched.block_of("OY", oy)), oy))

    def impl(p: dict, x):
        groups = x.shape[-1] if depthwise else 1
        return tiled_conv2d(x, p["w"], stride=stride, block_oy=block_oy, feature_groups=groups)

    return impl, block_oy


# the epilogues the fused conv kernel computes after its anchor
_FUSED_CHAINS = (["requant"], ["bias_add", "requant"], ["requant", "relu"], ["bias_add", "requant", "relu"])


def _fused_conv(seg: MappedSegment, inputs: tuple[str, ...]) -> bool:
    """Whether a ``tiled_conv`` segment maps onto the fused conv kernel: an
    int8 anchor (a missing ``elem_bytes`` means an unknown dtype), one
    input, and a chain of exactly [bias_add,] requant without folded
    ``scale``/``addend`` attrs [, relu].  Both conv ops qualify by their
    groups: ``conv2d`` has 1 and ``dwconv2d`` C; the kernel must take the
    filter (:func:`~repro_torch.kernels.conv_requant.supports`)."""
    anchor = seg.anchor
    depthwise = anchor.op == "dwconv2d"
    fy, fx = (int(anchor.attr(k, 1) or 1) for k in ("FY", "FX"))
    if not conv_supports(fy, fx, 1 if depthwise else int(anchor.attr("C", 1) or 1), depthwise=depthwise):
        return False
    eb = anchor.attr("elem_bytes", None)
    chain = [n.op for n in seg.nodes[1:]]
    if eb is None or int(eb) != 1 or len(inputs) != 1 or chain not in _FUSED_CHAINS:
        return False
    requant = next(n for n in seg.nodes if n.op == "requant")
    return not ("scale" in requant.attrs or "addend" in requant.attrs)


def _conv_fn(seg: MappedSegment, block_oy: int, ref_fn: Callable, lane: str):
    """conv/dwconv(+bias)+requant(+relu) as one launch of the Hopper conv.

    Activations are integer-valued inside int8 range by the
    integerized-graph contract, as for the GEMM (:func:`_gemm_fn`); the
    kernel reads them and the HWIO weight as stored and writes float32
    NHWC, so the segment issues that launch and nothing else (no pad,
    permute or epilogue kernel).  A run-time requant ``scale``/``addend``,
    or a shift the kernel's epilogue does not model (not an integer in
    [0, 31]), evaluates ``ref_fn`` — the segment's banded executor with its
    chain — instead: that is the segment's semantics, not a device
    fallback.  With tracing on, the launch is one ``node:<anchor op>``
    span on ``lane`` carrying the anchor's name."""
    anchor = seg.anchor
    stride = int(anchor.attr("stride", 1) or 1)
    depthwise = anchor.op == "dwconv2d"
    relu = seg.nodes[-1].op == "relu"
    bias_node = seg.nodes[1] if seg.nodes[1].op == "bias_add" else None
    requant_node = next(n for n in seg.nodes if n.op == "requant")
    attr_shift = requant_node.attr("shift", None)
    default_shift = 5.0 if attr_shift is None else float(attr_shift)
    span_name, span_attrs = f"node:{anchor.op}", {"name": anchor.name}

    def fn(seg_params: dict, x):
        rp = seg_params.get(requant_node.name, {})
        shift = float(rp.get("shift", default_shift))
        if "scale" in rp or "addend" in rp or not (shift.is_integer() and 0 <= shift <= 31):
            return ref_fn(seg_params, x)
        if x.dtype != torch.float32:
            x = x.to(torch.float32)  # as the reference's jnp.asarray(x, jnp.float32)
        bias = seg_params[bias_node.name]["b"] if bias_node is not None else None
        tr = obs.get_tracer()
        t0 = tr.now_us() if tr.enabled else 0.0
        y = conv_requant(x, seg_params[anchor.name]["w"], bias, stride=stride, depthwise=depthwise,
                         shift=int(shift), relu=relu, block_oy=block_oy)
        if tr.enabled:
            tr.complete(span_name, t0, cat="runtime", lane=lane, attrs=span_attrs)
        return y

    return fn


def _gemm_fn(seg: MappedSegment, ref_fn: Callable):
    """dense(+bias)+requant(+relu) as one launch of the Hopper int8 GEMM.

    Activations and weights are integer-valued by the integerized-graph
    contract (every route into a dense passes a requant clip), so the int8
    casts are lossless; the segment entry
    :func:`~repro_torch.kernels.matmul_requant.matmul_requant_f32` makes
    them in registers, reads the dense weight as stored ``(N, K)`` and
    writes float32, so the segment issues that launch and nothing else
    (no cast, no ``mult`` of ones, no zero bias).  Float32 activations go
    in as they are; another input dtype (a caller's int8 or int32 graph
    input) is first cast to float32, as the reference casts.  If the
    params supply a requant scale/addend at run time (which the GEMM
    epilogue does not model), the call evaluates ``ref_fn`` — the
    segment's fused reference executor — instead of diverging: that is the
    segment's semantics, not a device fallback.
    """
    anchor = seg.anchor
    has_relu = "relu" in [n.op for n in seg.epilogue]
    bias_node = next((n for n in seg.nodes if n.op == "bias_add"), None)
    requant_node = next(n for n in seg.nodes if n.op == "requant")
    attr_shift = requant_node.attr("shift", None)
    default_shift = 5.0 if attr_shift is None else float(attr_shift)

    def fn(seg_params: dict, x):
        rp = seg_params.get(requant_node.name, {})
        if "scale" in rp or "addend" in rp:
            return ref_fn(seg_params, x)
        if x.dtype != torch.float32:
            x = x.to(torch.float32)  # as the reference's jnp.asarray(x, jnp.float32)
        bias = seg_params[bias_node.name]["b"] if bias_node is not None else None
        shift = int(rp.get("shift", default_shift))
        return matmul_requant_f32(
            x.reshape(x.shape[0], -1), seg_params[anchor.name]["w"], bias,
            shift=shift, relu=has_relu, rounding="even",
        )

    return fn


# ---------------------------------------------------------------------------
# Route selection + entry point
# ---------------------------------------------------------------------------


def _kernel_schedule(seg: MappedSegment, target: MatchTarget) -> KernelSchedule | None:
    if seg.schedule is None or seg.workload is None:
        return None
    module = target.module(seg.module)
    return schedule_from_result(seg.schedule, seg.workload, module)


def _route_of(seg: MappedSegment) -> str:
    anchor = seg.anchor
    if anchor.op in ("conv2d", "dwconv2d"):
        return "tiled_conv"
    # only graphs explicitly integerized to 1-byte elems may take the int8
    # kernel (a missing attr means unknown dtype: fail safe to reference)
    eb = anchor.attr("elem_bytes", None)
    int8 = eb is not None and int(eb) == 1
    requant = next((n for n in seg.nodes if n.op == "requant"), None)
    # a folded requant carrying scale/addend attrs needs the general
    # affine epilogue — only the plain shift form maps onto the GEMM kernel
    plain_requant = requant is not None and not (
        "scale" in requant.attrs or "addend" in requant.attrs
    )
    if anchor.op == "dense" and plain_requant and int8:
        return "pallas_gemm"
    if seg.workload is None:
        return "structural"
    return "reference"


def lower(
    mapped: MappedGraph,
    target: MatchTarget | str | None = None,
    *,
    allow_spill: bool = True,
    hill_climb_iters: int = 200,
    device=None,
) -> CompiledModel:
    """Compile a MappedGraph into fused, memory-planned segment executors.

    ``target`` defaults to ``mapped.target``; a string is resolved as a
    registered target name (:mod:`repro_torch.targets.registry`) and must
    match the target the graph was dispatched on.  ``device`` is where the
    model runs: CUDA unless the caller asks for ``"cpu"`` — without a card
    the default raises, it never falls back.
    """
    dev = resolve_device(device)
    if target is None:
        target = mapped.target
    elif isinstance(target, str):
        # a name adds no information beyond a consistency check: resolve
        # it canonically (aliases included) without building a fresh
        # target, then lower against the dispatch target itself
        from repro_torch.targets.registry import get_target, target_info

        resolved = target_info(target)["name"]
        if resolved != mapped.target.name:
            # registry names need not equal MatchTarget.name (a factory
            # may decorate it): only the instantiated name is decisive
            actual = get_target(target).name
            if actual != mapped.target.name:
                raise LoweringError(
                    f"target {actual!r} does not match the dispatch target "
                    f"{mapped.target.name!r}"
                )
        target = mapped.target
    elif target is not mapped.target and target.name != mapped.target.name:
        raise LoweringError(
            f"target {target.name!r} does not match the dispatch target "
            f"{mapped.target.name!r}"
        )
    graph = mapped.graph

    # every graph output must be a segment boundary — fused chain internals
    # never materialize, so nothing else is addressable at runtime
    boundary = {s.output_node.name for s in mapped.segments}
    for o in graph.outputs:
        if graph.has(o) and o not in boundary:
            raise LoweringError(f"graph output {o} is fused inside a segment")
    covered = {n.name for s in mapped.segments for n in s.nodes}
    missing = {n.name for n in graph.nodes} - covered
    if missing:
        raise LoweringError(f"mapped graph does not cover nodes: {sorted(missing)}")

    lower_span = obs.span(
        "lower", cat="compile", graph=graph.name, target=target.name,
        segments=len(mapped.segments),
    )
    lower_span.__enter__()
    lowered: list[LoweredSegment] = []
    for i, seg in enumerate(mapped.segments):
        # chain internals must be single-consumer (the pattern matcher
        # guarantees it; re-checked here because lowering depends on it)
        for nd in seg.nodes[:-1]:
            ext = [c.name for c in graph.consumers(nd.name) if c.name not in {m.name for m in seg.nodes}]
            if ext:
                raise LoweringError(
                    f"segment {seg.anchor.name}: internal node {nd.name} "
                    f"is consumed outside the segment by {ext}"
                )
        inputs = seg.external_inputs(graph)
        out_name = seg.output_node.name
        with obs.span("lower.segment", cat="compile") as sp:
            ksched = _kernel_schedule(seg, target)
            route = _route_of(seg)
            sp.set(segment=seg.anchor.name, module=seg.module, route=route)
        obs.counter(f"lower.route.{route}").inc()
        meta: dict = {"pattern": seg.pattern}
        lane = f"run:{seg.module}"  # the segment's own span lane (CompiledModel.run)
        if route == "tiled_conv":
            impl, block_oy = _tiled_conv_impl(seg.anchor, ksched)
            fn = _fused_reference_fn(seg.nodes, inputs, out_name, anchor_impl=impl, lane=lane)
            meta["block_oy"] = block_oy
            fused = _fused_conv(seg, inputs)
            if fused:
                fn = _conv_fn(seg, block_oy, fn, lane)
            # the counter exists, at 0 if need be, wherever a conv is lowered
            obs.counter("lower.conv.fused").inc(int(fused))
            meta["kernel"] = "conv_requant" if fused else "banded"
        elif route == "pallas_gemm":
            ref_fn = _fused_reference_fn(seg.nodes, inputs, out_name, lane=lane)
            fn = _gemm_fn(seg, ref_fn)
            if ksched is not None:
                # the DSE's tile, as the TPU kernel's BlockSpecs took it
                k_out = int(seg.anchor.attr("K", 1) or 1)
                meta["dse_block"] = {
                    "M": int(ksched.block_of("B", 1)),
                    "N": int(ksched.block_of("K", k_out)),
                    "K": int(ksched.block_of("C", 1)),
                }
        else:
            fn = _fused_reference_fn(seg.nodes, inputs, out_name, lane=lane)
        lowered.append(
            LoweredSegment(
                index=i,
                segment=seg,
                route=route,
                input_names=inputs,
                output_name=out_name,
                fn=fn,
                kernel_schedule=ksched,
                meta=meta,
            )
        )

    plan = plan_memory(
        mapped, allow_spill=allow_spill, hill_climb_iters=hill_climb_iters
    )
    routes: dict[str, int] = {}
    for ls in lowered:
        routes[ls.route] = routes.get(ls.route, 0) + 1
    lower_span.set(routes=routes).__exit__(None, None, None)
    return CompiledModel(mapped=mapped, segments=lowered, memory_plan=plan, device=dev)
