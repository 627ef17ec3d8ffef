"""HLO-derived roofline statistics, with while-loop trip-count attribution.

``compiled.cost_analysis()`` counts each while-loop body ONCE regardless of
trip count — useless for scan-over-layers models (an 80-layer model reports
~1 layer of FLOPs).  This module parses ``compiled.as_text()`` instead:

  * splits the module into named computations,
  * reads each while op's ``known_trip_count`` backend config,
  * propagates multipliers through the call graph
    (entry -> while bodies x trip, fusions/calls x 1),
  * per computation, accumulates
      - dot FLOPs: 2 * prod(result dims) * prod(contracted dims),
      - HBM bytes: operand + result bytes of each instruction AT THE
        FUSION BOUNDARY (fusion internals live in registers/VMEM and are
        excluded — their dots still count toward FLOPs),
      - collective bytes: result bytes of all-gather / all-reduce /
        reduce-scatter / all-to-all / collective-permute (skipping the
        ``-done`` halves of async pairs).

All numbers are per device: post-SPMD shapes in the HLO are shards.

A copy of ``repro.launch.hlo_stats`` (host-only text parsing).  The port
lowers nothing through XLA; here it reads HLO text that the reference
dumps (``compiled.as_text()``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# "  %name = <shapes> opcode(operands...), attrs" ; shapes may be a tuple
_INSTR_RE = re.compile(
    r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\))|(?:[\w\[\],]+(?:\{[^}]*\})?))\s+"
    r"([\w\-]+)\(",
)
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLED_RE = re.compile(
    r"(?:condition|body|to_apply|calls)=%?([\w.\-]+)"
    r"|branch_computations=\{([^}]*)\}"
)

_COLLECTIVES = {
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "all-gather-start", "all-reduce-start",
    "reduce-scatter-start", "all-to-all-start", "collective-permute-start",
    "ragged-all-to-all",
}
_NO_TRAFFIC_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id",
}

# elementwise / reduction opcodes counted as 1 FLOP per output element
# (matches XLA's HloCostAnalysis convention closely enough to validate
# within ~15% against fully-unrolled cost_analysis()).
_ELEMENTWISE_FLOP_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "exponential", "exponential-minus-one", "tanh", "rsqrt", "sqrt",
    "power", "log", "log-plus-one", "negate", "abs", "cosine", "sine",
    "logistic", "atan2", "remainder", "floor", "ceil", "round-nearest-afz",
}
_REDUCE_OPS = {"reduce", "reduce-window"}


def _shape_dims(shape_str: str):
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype in _DTYPE_BYTES:
            dim_list = [int(d) for d in dims.split(",") if d]
            yield dtype, dim_list


def _shape_elems(shape_str: str) -> int:
    total = 0
    for _, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n
    return total


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class _Instr:
    name: str
    shape: str
    opcode: str
    line: str


@dataclass
class _Computation:
    name: str
    instrs: list = field(default_factory=list)
    shapes: dict = field(default_factory=dict)  # defined name -> shape str
    # (called_comp, trip multiplier) edges
    calls: list = field(default_factory=list)
    fusion_bodies: set = field(default_factory=set)


_LINE_START_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%[\w.\-]+\s*=|^ENTRY|^%|^\}|^HloModule"
)


def _logical_lines(txt: str):
    """Join wrapped instructions (the HLO printer breaks long tuples)."""
    buf: list[str] = []
    for line in txt.splitlines():
        if _LINE_START_RE.match(line):
            if buf:
                yield " ".join(buf)
            buf = [line]
        elif buf:
            buf.append(line.strip())
        else:
            buf = [line]
    if buf:
        yield " ".join(buf)


def _parse_computations(txt: str) -> tuple[dict[str, _Computation], str]:
    comps: dict[str, _Computation] = {}
    entry = None
    cur: _Computation | None = None
    for line in _logical_lines(txt):
        hdr = _COMP_HDR_RE.match(line)
        if hdr and "{" in line:
            cur = _Computation(hdr.group(1))
            comps[cur.name] = cur
            if line.startswith("ENTRY"):
                entry = cur.name
            continue
        if cur is None:
            continue
        if line.startswith("}"):
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            # parameters: "  %p = f32[...] parameter(0)" matches; others skip
            continue
        name, shape, opcode = m.group(1), m.group(2), m.group(3)
        cur.shapes[name] = shape
        cur.instrs.append(_Instr(name, shape, opcode, line))
        if opcode == "while":
            trip = _TRIP_RE.search(line)
            n = int(trip.group(1)) if trip else 1
            for cm in _CALLED_RE.finditer(line):
                target = cm.group(1)
                if target:
                    cur.calls.append((target, n))
        else:
            for cm in _CALLED_RE.finditer(line):
                if cm.group(1):
                    cur.calls.append((cm.group(1), 1))
                    if opcode == "fusion":
                        cur.fusion_bodies.add(cm.group(1))
                elif cm.group(2):
                    for t in re.findall(r"%?([\w.\-]+)", cm.group(2)):
                        cur.calls.append((t, 1))
    if entry is None:
        entry = next(iter(comps))
    return comps, entry


def _multipliers(comps: dict[str, _Computation], entry: str):
    mult: dict[str, float] = {name: 0.0 for name in comps}
    no_bytes: set[str] = set()  # fusion/apply bodies: VMEM-internal

    def visit(name: str, m: float, inside_fusion: bool):
        if name not in comps:
            return
        mult[name] += m
        if inside_fusion:
            no_bytes.add(name)
        c = comps[name]
        for target, trip in c.calls:
            child_fusion = inside_fusion or target in c.fusion_bodies \
                or _is_small_apply(comps.get(target))
            visit(target, m * trip, child_fusion)

    visit(entry, 1.0, False)
    return mult, no_bytes


def _is_small_apply(comp: _Computation | None) -> bool:
    """reduce/scatter to_apply bodies — scalar lambdas, no HBM traffic."""
    return comp is not None and len(comp.instrs) <= 4


_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def _dot_flops(comp: _Computation, instr: _Instr) -> float:
    out_elems = 0
    for _, dims in _shape_dims(instr.shape):
        n = 1
        for d in dims:
            n *= d
        out_elems += n
    m = _CONTRACT_RE.search(instr.line)
    contract = 1
    if m:
        operands = re.findall(r"%([\w.\-]+)", instr.line.split("(", 1)[1])
        lhs_shape = comp.shapes.get(operands[0]) if operands else None
        if lhs_shape:
            dims_list = next(iter(_shape_dims(lhs_shape)), (None, []))[1]
            for di in m.group(1).split(","):
                if di and int(di) < len(dims_list):
                    contract *= dims_list[int(di)]
    return 2.0 * out_elems * contract


def _fusion_effective_bytes(
    comps: dict[str, _Computation], comp: _Computation, instr: _Instr
) -> tuple[int, int] | None:
    """(operand bytes, result bytes) for a fusion call, charging only what
    the body actually TOUCHES:

      * a body parameter whose only users are slice/dynamic-slice/gather
        is charged at the sliced size, not the full array (a scan body
        reading one chunk of a big stacked input does not stream the
        whole input from HBM every iteration);
      * if the body root is a dynamic-update-slice (in-place buffer
        update under XLA aliasing), the result is charged at the update
        size, not the full buffer.
    """
    m = re.search(r"calls=%?([\w.\-]+)", instr.line)
    if not m or m.group(1) not in comps:
        return None
    body = comps[m.group(1)]
    param_shape: dict[str, str] = {}
    users: dict[str, list[_Instr]] = {}
    for bi in body.instrs:
        if bi.opcode == "parameter":
            param_shape[bi.name] = bi.shape
        ops = re.findall(r"%([\w.\-]+)", bi.line.split("(", 1)[1])
        for op in ops:
            users.setdefault(op, []).append(bi)
    op_bytes = 0
    for pname, pshape in param_shape.items():
        us = users.get(pname, [])
        if us and all(
            u.opcode in ("dynamic-slice", "slice", "gather") for u in us
        ):
            op_bytes += sum(_shape_bytes(u.shape) for u in us)
        else:
            op_bytes += _shape_bytes(pshape)
    root = body.instrs[-1] if body.instrs else None
    if root is not None and root.opcode == "dynamic-update-slice":
        ops = re.findall(r"%([\w.\-]+)", root.line.split("(", 1)[1])
        upd = body.shapes.get(ops[1]) if len(ops) > 1 else None
        res_bytes = _shape_bytes(upd) if upd else _shape_bytes(instr.shape)
    elif root is not None and root.opcode == "scatter":
        # in-place under aliasing: traffic = the updates, not the buffer
        ops = re.findall(r"%([\w.\-]+)", root.line.split("(", 1)[1])
        upd = body.shapes.get(ops[2]) if len(ops) > 2 else None
        res_bytes = _shape_bytes(upd) if upd else _shape_bytes(instr.shape)
    else:
        res_bytes = _shape_bytes(instr.shape)
    return op_bytes, res_bytes


def _instr_bytes(
    comp: _Computation, instr: _Instr,
    comps: dict[str, _Computation] | None = None,
) -> int:
    if instr.opcode in _NO_TRAFFIC_OPS:
        return 0
    if instr.opcode == "fusion" and comps is not None:
        eff = _fusion_effective_bytes(comps, comp, instr)
        if eff is not None:
            return eff[0] + eff[1]
    if instr.opcode in ("dynamic-slice", "slice", "gather"):
        # reads only the slice, plus writes it
        return 2 * _shape_bytes(instr.shape)
    if instr.opcode == "dynamic-update-slice":
        operands = re.findall(r"%([\w.\-]+)", instr.line.split("(", 1)[1])
        upd = comp.shapes.get(operands[1]) if len(operands) > 1 else None
        if upd:
            return 2 * _shape_bytes(upd)
    if instr.opcode == "scatter":
        operands = re.findall(r"%([\w.\-]+)", instr.line.split("(", 1)[1])
        upd = comp.shapes.get(operands[2]) if len(operands) > 2 else None
        if upd:
            return 2 * _shape_bytes(upd)
    total = _shape_bytes(instr.shape)  # result
    operands = re.findall(r"%([\w.\-]+)", instr.line.split("(", 1)[1])
    for op in operands:
        s = comp.shapes.get(op)
        if s:
            total += _shape_bytes(s)
    return total


def hlo_stats(txt: str) -> dict:
    """Per-device {flops, hbm_bytes, collective_bytes, collectives{kind:
    {count, bytes}}} with loop trip counts applied."""
    comps, entry = _parse_computations(txt)
    mult, no_bytes = _multipliers(comps, entry)

    flops = 0.0
    hbm = 0.0
    coll: dict[str, dict[str, float]] = {}
    sites: list[tuple[float, str, str, float, str]] = []
    for name, comp in comps.items():
        m = mult[name]
        if m == 0:
            continue
        count_bytes = name not in no_bytes
        for instr in comp.instrs:
            if instr.opcode == "dot":
                flops += m * _dot_flops(comp, instr)
            elif instr.opcode in _ELEMENTWISE_FLOP_OPS:
                flops += m * _shape_elems(instr.shape)
            elif instr.opcode in _REDUCE_OPS:
                # ~1 flop per input element; use first operand's size
                operands = re.findall(
                    r"%([\w.\-]+)", instr.line.split("(", 1)[1]
                )
                if operands and operands[0] in comp.shapes:
                    flops += m * _shape_elems(comp.shapes[operands[0]])
            if not count_bytes:
                continue
            if instr.opcode in _COLLECTIVES:
                kind = instr.opcode.replace("-start", "")
                b = _shape_bytes(instr.shape)
                e = coll.setdefault(kind, {"count": 0, "bytes": 0.0})
                e["count"] += m
                e["bytes"] += m * b
                sites.append((m * b, kind, instr.shape, m, name))
                hbm += m * _instr_bytes(comp, instr, comps)
            elif instr.opcode.endswith("-done"):
                continue
            else:
                hbm += m * _instr_bytes(comp, instr, comps)

    sites.sort(reverse=True)
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        "collective_bytes": sum(v["bytes"] for v in coll.values()),
        "collectives": coll,
        "top_collective_sites": [
            {"bytes": b, "kind": k, "shape": s[:120], "mult": m, "comp": c}
            for b, k, s, m, c in sites[:12]
        ],
    }


def collective_bytes(txt: str) -> dict[str, dict[str, float]]:
    return hlo_stats(txt)["collectives"]


def total_collective_bytes(txt: str) -> int:
    return int(hlo_stats(txt)["collective_bytes"])
