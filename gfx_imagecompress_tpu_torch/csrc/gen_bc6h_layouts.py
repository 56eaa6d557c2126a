"""Writes ``bc6h_layouts.cuh``, the BC6H mode table and bit layouts of the
CUDA search, and ``bc6h_layouts.inc``, the same layouts for the native decode
oracle (``bcn_decode.cpp``), from the port's ``tables/bc6h_tables.py``, so
that the kernel, the oracle and the PyTorch encoder and decoder share one
source of truth.

    python gfx_imagecompress_tpu_torch/csrc/gen_bc6h_layouts.py [DIR]

writes both files into ``DIR`` (by default this script's directory).

Both files are committed; ``tests/test_torch_bc6h.py`` holds the header and
``tests/test_torch_native.py`` the oracle's include equal to what this script
writes now.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _tables():
    """The port's tables module, loaded from its file (the package itself
    need not be importable from where this script runs)."""
    path = HERE.parent / "tables" / "bc6h_tables.py"
    spec = importlib.util.spec_from_file_location("_bc6h_tables", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


def render() -> str:
    t = _tables()
    nseg = max(len(t.LAYOUTS[m.mode]) for m in t.BC6H_MODES)
    out = [
        "// Generated by gen_bc6h_layouts.py from tables/bc6h_tables.py - do "
        "not edit.",
        "//",
        "// MODES[i] describes BC6H mode i + 1: the mode field's value and "
        "width, the",
        "// base endpoint's precision, the r/g/b precisions of the other "
        "three",
        "// endpoints, whether those are deltas from the base, the region "
        "count and",
        "// the number of layout segments. SEGS[i][s] is segment s of its "
        "layout:",
        "// (field, source bit, destination bit, width), field f being "
        "endpoint f / 3",
        "// (w, x, y, z) of channel f % 3.",
        "#pragma once",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        "namespace bc6h {",
        "",
        "struct ModeInfo {",
        "  uint8_t code, code_bits, base_bits, delta_bits[3], transformed, "
        "regions, nseg;",
        "};",
        "",
        f"constexpr int NMODES = {len(t.BC6H_MODES)};",
        f"constexpr int MAX_SEGS = {nseg};",
        f"constexpr int TWO_REGION_SHAPE_BIT = {t.TWO_REGION_SHAPE_BIT};",
        f"constexpr int TWO_REGION_INDEX_BIT = {t.TWO_REGION_INDEX_BIT};",
        f"constexpr int ONE_REGION_INDEX_BIT = {t.ONE_REGION_INDEX_BIT};",
        "",
        "__constant__ ModeInfo MODES[NMODES] = {",
    ]
    for m in t.BC6H_MODES:
        db = ", ".join(str(b) for b in m.delta_bits)
        out.append(f"    {{0x{m.code:02X}, {m.code_bits}, {m.base_bits}, "
                   f"{{{db}}}, {int(m.transformed)}, {m.regions}, "
                   f"{len(t.LAYOUTS[m.mode])}}},  // mode {m.mode}")
    out += ["};", "", "__constant__ uint8_t SEGS[NMODES][MAX_SEGS][4] = {"]
    for m in t.BC6H_MODES:
        segs = [f"{{{t.FIELDS.index(f)}, {s}, {d}, {n}}}"
                for f, s, d, n in t.LAYOUTS[m.mode]]
        out.append(f"    {{  // mode {m.mode}")
        for i in range(0, len(segs), 6):
            out.append("        " + ", ".join(segs[i:i + 6]) + ",")
        out.append("    },")
    out += ["};", "", "}  // namespace bc6h", ""]
    return "\n".join(out)


def render_oracle() -> str:
    """The oracle's include: every mode's segments (field, source bit,
    destination bit, width) in one array, each layout ended by a zero
    segment, and a pointer to each mode's first segment."""
    t = _tables()
    lines = ["// generated by gen_bc6h_layouts.py - do not edit",
             "static const Seg kBc6hLayoutData[] = {"]
    offsets = []
    total = 0
    for m in t.BC6H_MODES:
        offsets.append(total)
        for field, src, dst, n in t.LAYOUTS[m.mode]:
            lines.append(f"  {{{t.FIELDS.index(field)}, {src}, {dst}, {n}}},")
            total += 1
        lines.append("  {0, 0, 0, 0},")  # terminator
        total += 1
    lines.append("};")
    lines.append(f"static const Seg *kBc6hLayouts[{len(offsets)}] = {{")
    lines += [f"  kBc6hLayoutData + {off}," for off in offsets]
    lines.append("};")
    return "\n".join(lines) + "\n"


def main(argv) -> int:
    out = Path(argv[1]) if len(argv) > 1 else HERE
    (out / "bc6h_layouts.cuh").write_text(render())
    (out / "bc6h_layouts.inc").write_text(render_oracle())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
