"""Measurements of ``fixed_order_dot`` on the card beyond ``chip_smoke.py``.

Run from the repo root on a machine with the card (it reuses
``chip_smoke.py``'s phases and prints their lines):

    python3 gemv_probe.py phases    # [gemv] and its device split, twice
    python3 gemv_probe.py stages    # fold designs side by side
    python3 gemv_probe.py pagerank  # [pagerank] with and without the
                                    # split's child process just before
    python3 gemv_probe.py repeat    # [gemv] and [segment], three times

``stages`` builds ``csrc/gemv.cu`` with other fold stages (slices a
stage, stages a ring) and with the fold's adds in register batches of
16, each into ``spartan_tpu_torch/_build/`` under its own name, and
times the tall (2^22, 32) shapes and the 16,384^2 ones through each,
checking every result against the plain version and the first design.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from spartan_tpu_torch.kernels import build as build_mod  # noqa: E402
from spartan_tpu_torch.kernels import gemv as kg  # noqa: E402

# (slices a stage, stages a ring, adds in register batches)
STAGES = ((128, 8, False), (128, 8, True), (256, 6, False),
          (384, 4, False), (512, 3, False))
BATCHED = """      float v[16], w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = src[j * 32];
#pragma unroll
      for (int i = 0; i < kFoldRows; i += 32) {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = src[(i + 16 + j) * 32];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc = add(acc, v[j]);
        if (i + 32 < kFoldRows) {
#pragma unroll
          for (int j = 0; j < 16; ++j) v[j] = src[(i + 32 + j) * 32];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) acc = add(acc, w[j]);
      }
"""


def _quiet(fn, *args):
    """``fn(*args)`` and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def _variant(src: str, rows: int, ring: int, batched: bool) -> str:
    out = re.sub(r"constexpr int kFoldRows = \d+;",
                 f"constexpr int kFoldRows = {rows};", src)
    out = re.sub(r"constexpr int kRing = \d+;",
                 f"constexpr int kRing = {ring};", out)
    if batched:
        full = re.compile(r"(    if \(left >= kFoldRows\) \{[^\n]*\n)"
                          r"#pragma unroll\n[^\n]*\n")
        out, n = full.subn(lambda m: m.group(1) + BATCHED, out)
        if n != 1:
            cs._fail("gemv_probe: the fold's full-stage loop was not found")
    return out


def stages(card: str, dev) -> None:
    with open(os.path.join(build_mod.CSRC, "gemv.cu")) as f:
        src = f.read()
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    rows, cols = cs.GEMV_TALL
    a = torch.rand((rows, cols), generator=gen, device=dev).mul_(2).sub_(1)
    x = torch.rand((rows,), generator=gen, device=dev).mul_(2).sub_(1)
    at = a.t().contiguous()
    sq = torch.rand((16384, 16384), generator=gen, device=dev).mul_(2).sub_(1)
    xs = torch.rand((16384,), generator=gen, device=dev).mul_(2).sub_(1)
    cases = (("tall x @ A", x, a, "vecmat", cs.GEMV_TALL_WINDOWS),
             ("tall A @ x", x, at, "matvec", cs.GEMV_TALL_WINDOWS),
             ("16384^2 x @ A", xs, sq, "vecmat", cs.GEMV_WINDOWS),
             ("16384^2 A @ x", xs, sq, "matvec", cs.GEMV_WINDOWS))
    csrc = os.path.join(build_mod.BUILD_DIR, "probe_src")
    os.makedirs(csrc, exist_ok=True)
    names = []
    for rows_, ring, batched in STAGES:
        name = f"gemv_fold{rows_}x{ring}{'b' if batched else ''}"
        with open(os.path.join(csrc, name + ".cu"), "w") as f:
            f.write(_variant(src, rows_, ring, batched))
        names.append(name)
    build_mod.CSRC = csrc
    build_mod.build_all(names)
    first = None
    for rep in range(2):
        for name in names:
            lib = build_mod.load(name, kg._bind)
            kg._load = lambda lib=lib: lib
            for label, vec, mat, orient, windows in cases:
                got, _ = _quiet(cs._gemv_case, kg, f"{name} {label}", vec,
                                mat, orient, windows, card)
                pair = (vec, mat) if orient == "vecmat" else (mat, vec)
                split = cs._gemv_split(kg, pair, got["ms"])
                cs._say(f"[probe] rep {rep} {name} {label}: kernel "
                        f"{got['ms']:.4f} ms, torch.matmul "
                        f"{got['library_ms']:.4f} ms; {split} on {card}")
            outs = (kg.fixed_order_dot(x, a), kg.fixed_order_dot(at, x))
            first = first or outs
            if not all(torch.equal(p, q) for p, q in zip(outs, first)):
                cs._fail(f"gemv_probe: {name} differs from {names[0]}")
    cs._say("[probe] every design bit-equal to the first")


def pagerank(card: str, dev) -> None:
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import pagerank as pr
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.kernels import segment as ks

    st.set_default_device(dev)
    cs._COUNTED[:] = [ks, kg]
    build_mod.build_all(["kmeans", "segment", "gemv"])
    kk._load()
    ks._load()
    g = cs.phase_gemv(kg, card, dev)
    links = cs.pagerank_links(st.SparseDistArray)
    links.transition()._ensure_plan()
    for i in range(4):
        for arm in ("no split before", "split child just before"):
            if arm.startswith("split"):
                _quiet(cs.phase_gemv_split, card, g["cases"])
            _, lines = _quiet(cs.phase_pagerank, kk, ks, pr, links, card,
                              dev)
            m = re.search(r"([0-9.]+) iters/s.*teleport ([0-9.]+) ms",
                          next(ln for ln in lines if "iters/s" in ln))
            cs._say(f"[probe] round {i} {arm}: {m.group(1)} iters/s, "
                    f"teleport {m.group(2)} ms on {card}")


def repeat(card: str, dev) -> None:
    from spartan_tpu_torch.kernels import segment as ks

    cs._COUNTED[:] = [ks, kg]
    build_mod.build_all(["segment", "gemv"])
    ks._load()
    for i in range(3):
        cs._say(f"[probe] round {i}")
        cs.phase_gemv(kg, card, dev)
        for _ in range(2):
            cs.phase_segment_ab(ks, card, dev)


def phases(card: str, dev) -> None:
    cs._COUNTED[:] = [kg]
    for _ in range(2):
        g = cs.phase_gemv(kg, card, dev)
        cs.phase_gemv_split(card, g["cases"])


def main() -> None:
    modes = {"phases": phases, "stages": stages, "pagerank": pagerank,
             "repeat": repeat}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        cs._fail(f"usage: python3 gemv_probe.py {{{','.join(modes)}}}")
    if not torch.cuda.is_available():
        cs._fail("gemv_probe measures on the card: no CUDA device")
    card = cs.phase_device()
    build_mod.build_all(["gemv"])
    kg._load()
    modes[sys.argv[1]](card, torch.device("cuda"))


if __name__ == "__main__":
    main()
