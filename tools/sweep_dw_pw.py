"""Where the fused dw->pw kernel's time goes on one NVIDIA card, and how
good ``dw_pw_fused.plan()`` is: at every distinct MobileNet-V1/V2 block
shape (224 px, batch 1), the mma variant's time at the plan's tiles, at
every other tile, Cout tile, channel chunk and split that fits (the
autotuner's candidates, ``dw_pw_fused.plan_candidates``), and (with
``--knockouts``) copies of the kernel with one part taken out (the
depthwise, the halo copies, the tensor-core product, or all three with
the taps and weight copies: a bare launch with its epilogue).

    python3 tools/sweep_dw_pw.py [--knockouts]   # needs a card and nvcc

Times are CUDA events over CUDA-graph replays (``chip_smoke.time_ms``),
L2-warm. Writes build/sweep_dw_pw.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import bf16_tol, compare, time_ms  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.kernels.sparse_conv import same_pads  # noqa: E402

OUT = ROOT / "build" / "sweep_dw_pw"
_P, _I = ctypes.c_void_p, ctypes.c_int

# (old, new) source edits that take one part of dw_pw_mma out
_DEPTHWISE = ("      if (i < tr * tw && oy0 + ty < Ho && ox0 + tx < Wo) {",
              "      if (false) {")
_HALO = ("    for (int e = tid; e < hr * hc * groups; e += MMA_THREADS) {",
         "    for (int e = tid; e < 0; e += MMA_THREADS) {")
_MMA = ("    for (int kc = 0; kc < ck / 16; ++kc) {",
        "    for (int kc = 0; kc < 0; ++kc) {")
_REST = [("    for (int e = tid; e < ck * TG; e += MMA_THREADS) {",
          "    for (int e = tid; e < 0; e += MMA_THREADS) {"),
         ("    for (int e = tid; e < K * K * groups; e += MMA_THREADS) {",
          "    for (int e = tid; e < 0; e += MMA_THREADS) {")]
KNOCKOUTS = {"no_depthwise": [_DEPTHWISE], "no_halo": [_HALO],
             "no_mma": [_MMA], "bare": [_DEPTHWISE, _HALO, _MMA] + _REST}


def build(knockouts: bool) -> dict:
    """lib name -> loaded copy of csrc/dw_pw.cu (as it is, and with each
    knockout), one nvcc each, all in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "dw_pw.cu").read_text()
    sources = {"dw_pw": src}
    for name, edits in (KNOCKOUTS.items() if knockouts else ()):
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"knockout {name}: {old!r} not in dw_pw.cu")
            s = s.replace(old, new)
        sources[name] = s
    procs = {}
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    for name, s in sources.items():
        (OUT / f"{name}.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.dw_pw_launch.argtypes = [_P] * 8 + [_I] * 21 + [_P]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--knockouts", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_dw_pw: needs a card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = build(args.knockouts)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    shapes, seen = [], set()
    for arch in ("mobilenet_v1", "mobilenet_v2"):
        for nd in fused_graph_for(arch).nodes:
            key = (nd.in_hw, nd.cin, nd.cout, nd.stride, bool(nd.residual_from))
            if nd.kind == "dw_pw" and key not in seen:
                seen.add(key)
                shapes.append((f"{arch[-2:]} {nd.name}",) + key)
    rows = []
    for label, h, c, co, stride, residual in shapes:
        ho, ph, _ = same_pads(h, 3, stride)
        x, dw_w, dw_b = rnd((1, h, h, c)), rnd((3, 3, c), 1 / 3), rnd((c,), 0.1)
        pw_w, pw_b = rnd((c, co), c ** -0.5), rnd((co,), 0.1)
        res = rnd((1, ho, ho, co)) if residual else None
        out = torch.empty((1, ho, ho, co), dtype=torch.bfloat16, device=dev)
        want = dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, res, stride=stride)

        def launch(lib, tm, tn, tr, tw, ck, split):
            err = lib.dw_pw_launch(
                x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
                pw_b.data_ptr(), None if res is None else res.data_ptr(),
                None, out.data_ptr(), 1, h, h, c, ho, ho, 3, stride, ph, ph, co,
                1, 1, _build.weight_code(torch.bfloat16), 1, tm, tn, tr, tw, ck,
                split,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{label}: launch failed ({err})")

        p = dwpw.plan(1, ho, ho, c, co, 3, stride)
        cfg = (p.tm, p.tn, p.tr, p.tw, p.ck, p.split)
        times = {}
        for name, lib in libs.items():
            times[name] = time_ms(lambda: launch(lib, *cfg)) * 1e3
        launch(libs["dw_pw"], *cfg)
        torch.cuda.synchronize()
        compare(out, want, bf16_tol, label)
        sweep = []
        for q in dwpw.plan_candidates(1, ho, ho, c, co, 3, stride):
            t = time_ms(lambda: launch(libs["dw_pw"], q.tm, q.tn, q.tr, q.tw,
                                       q.ck, q.split)) * 1e3
            sweep.append((t, q.tm, q.tn, q.ck, q.split))
        sweep.sort()
        best = sweep[0]
        rows.append({"block": label, "plan": p._asdict(), "us": times,
                     "best": dict(zip(("us", "tm", "tn", "ck", "split"), best)),
                     "configs": len(sweep)})
        print(f"{label:16s} C{c:5d} Cout{co:5d} out {ho:3d}: plan tm{p.tm} "
              f"tn{p.tn} ck{p.ck} S{p.split} " + ", ".join(
                  f"{k} {v:.2f}" for k, v in times.items())
              + f" us; best of {len(sweep)}: tm{best[1]} tn{best[2]} "
              f"ck{best[3]} S{best[4]} {best[0]:.2f} us (plan "
              f"+{times['dw_pw'] - best[0]:.2f})")
    gaps = [r["us"]["dw_pw"] - r["best"]["us"] for r in rows]
    print(f"plan within 0.5 us of the sweep's best at "
          f"{sum(g <= 0.5 for g in gaps)} of {len(gaps)} shapes, within 1 us "
          f"at {sum(g <= 1.0 for g in gaps)}; worst +{max(gaps):.2f} us")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "sweep_dw_pw.json").write_text(json.dumps(
        {"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
