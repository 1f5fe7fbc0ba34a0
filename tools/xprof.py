#!/usr/bin/env python
"""Minimal XSpace (.xplane.pb) parser: per-op device-time summary.

``jax.profiler.trace`` writes XSpace protos; this parses the wire format
directly, with no proto or TensorBoard dependency.  It aggregates event
durations per (line, op) on the device planes (``/device:GPU:N``; each
CUDA stream is one line, each kernel one event): the quickest way to see
where a compiled program's device time goes.  :func:`hlo_fusion_bytes`
adds the bytes each fusion of a compiled program reads and writes, taken
from its optimized HLO text, so a kernel's time can be set against its
byte floor.

Usage:
    python tools/xprof.py <trace dir> [--top 40] [--merge-prefix]

The reference library has no tracing/profiling subsystem (SURVEY.md §5);
this plus scripts/profile_transform.py is this package's equivalent.
"""

import argparse
import collections
import glob
import re
import sys


def _varint(buf, i):
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError("bad wire type %d" % wt)
        yield fn, wt, v


def parse_xspace(path):
    """-> list of planes: (name, {metadata_id: op_name},
    [(line_name, [(metadata_id, duration_ps), ...]), ...])"""
    data = open(path, "rb").read()
    planes = []
    for fn, wt, v in _fields(data):
        if fn != 1 or wt != 2:
            continue
        name = ""
        meta = {}
        lines = []
        for pf, pw, pv in _fields(v):
            if pf == 2 and pw == 2:
                name = pv.decode("utf-8", "replace")
            elif pf == 3 and pw == 2:          # XLine
                lname = ""
                events = []
                for lf, lw, lv in _fields(pv):
                    if lf == 2 and lw == 2:
                        lname = lv.decode("utf-8", "replace")
                    elif lf == 4 and lw == 2:  # XEvent
                        mid = dur = 0
                        for ef, ew, ev in _fields(lv):
                            if ef == 1 and ew == 0:
                                mid = ev
                            elif ef == 3 and ew == 0:
                                dur = ev
                        events.append((mid, dur))
                lines.append((lname, events))
            elif pf == 4 and pw == 2:          # map<int64, XEventMetadata>
                mid = None
                for mf, mw, mv in _fields(pv):
                    if mf == 1 and mw == 0:
                        mid = mv
                    elif mf == 2 and mw == 2:  # XEventMetadata
                        eid = 0
                        nm = dnm = ""
                        for ef, ew, ev in _fields(mv):
                            if ef == 1 and ew == 0:
                                eid = ev
                            elif ef == 2 and ew == 2:
                                nm = ev.decode("utf-8", "replace")
                            elif ef == 3 and ew == 2:
                                dnm = ev.decode("utf-8", "replace")
                        meta[mid if mid is not None else eid] = dnm or nm
                if mid is not None and mid not in meta:
                    meta[mid] = ""
        planes.append((name, meta, lines))
    return planes


_FUSION_N = re.compile(r"\.\d+$")


def summarize(path, top=40, merge=False, line_filter=None):
    out = []
    for name, meta, lines in parse_xspace(path):
        if "/device:" not in name:
            continue
        per_line = collections.Counter()
        per_op = collections.Counter()
        op_count = collections.Counter()
        for lname, events in lines:
            if line_filter and line_filter not in lname:
                continue
            for mid, dur in events:
                us = dur / 1e6
                per_line[lname] += us
                op = meta.get(mid, "?")
                if merge:
                    op = _FUSION_N.sub("", op)
                per_op[(lname, op)] += us
                op_count[(lname, op)] += 1
        out.append((name, per_line, per_op, op_count))
    return out


_ELEM_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
               "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
               "u64": 8, "c64": 8, "c128": 16}
_SHAPE = re.compile(r"\b(%s)\[([\d,]*)\]" % "|".join(_ELEM_BYTES))
_INSTR = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = ")


def _type_bytes(text):
    total = 0
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _ELEM_BYTES[dt]
    return total


def hlo_fusion_bytes(hlo_text):
    """{kernel name: (bytes read + written, output type)} for every fusion
    and custom call in the ENTRY computation of an optimized HLO module
    (``jitted.lower(...).compile().as_text()``).  Each operand counts once,
    whole, so a fusion that reads a slice of an operand is over-counted.
    Kernel names are the instruction names with '.' -> '_', as the GPU
    trace shows them."""
    lines = hlo_text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("ENTRY"))
    types, out = {}, {}
    for line in lines[start + 1:]:
        m = _INSTR.match(line)
        if not m:
            continue
        name, rest = m.group(1), line[m.end():]
        if rest.startswith("("):           # tuple type: up to its ')'
            depth = 0
            for j, ch in enumerate(rest):
                depth += {"(": 1, ")": -1}.get(ch, 0)
                if depth == 0:
                    break
            typ, rest = rest[:j + 1], rest[j + 2:]
        else:
            typ, _, rest = rest.partition(" ")
        types[name] = typ
        opcode = rest.split("(", 1)[0]
        if opcode not in ("fusion", "custom-call"):
            continue
        args = rest.split("(", 1)[1].split("), ")[0]
        ops = set(re.findall(r"%([\w.\-]+)", args))
        nbytes = _type_bytes(typ) + sum(_type_bytes(types.get(o, ""))
                                        for o in ops)
        out[name.replace(".", "_")] = (nbytes, typ)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logdir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--merge-prefix", action="store_true",
                    help="merge trailing .N fusion indices")
    ap.add_argument("--line", default=None, help="only lines containing this")
    args = ap.parse_args()
    files = sorted(glob.glob(args.logdir + "/**/*.xplane.pb", recursive=True))
    if not files:
        sys.exit("no .xplane.pb under %s" % args.logdir)
    for name, per_line, per_op, op_count in summarize(
            files[-1], args.top, args.merge_prefix, args.line):
        print("== plane %s" % name)
        for ln, us in per_line.most_common(8):
            print("   line %-28s %10.0f us" % (ln[:28], us))
        for (ln, op), us in per_op.most_common(args.top):
            print("   %9.0f us  x%-4d %s | %s"
                  % (us, op_count[(ln, op)], ln[:14], op[:90]))


if __name__ == "__main__":
    main()
