#!/usr/bin/env python3
"""Where the bf16 moe_ffn kernel departs from its own roundings, on a card.

    python3 scripts/moe_ffn_rounding.py

The kernel rounds h = silu(x wg) * (x wu) to bf16 and then y = h wd to
bf16.  This script emulates those roundings with fp32 products (cuBLAS,
TF32 off) and counts, for the tensor-core path and the fp32-FMA path on
the same bf16 inputs (4 experts x 1024 rows, D = 2048, F = 1024), how
many bf16 ulps each y value is from the emulation.  With wd the identity
(D = F = 1024) y is h itself, which isolates the first phase.  It prints
one JSON line per comparison and the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import moe_ffn as kmoe  # noqa: E402


def launch(wgmma: bool, bc: int, xs, wg, wu, wd):
    """The kernel on a chosen path (the wrapper picks the tensor cores for
    bf16 on its own)."""
    y = torch.empty_like(xs)
    E, C, D = xs.shape
    F = wg.shape[2]
    h = torch.empty((E, C, F), dtype=xs.dtype, device=xs.device)
    rc = kmoe._lib().moe_ffn_launch(
        1, int(wgmma), bc, xs.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), y.data_ptr(), h.data_ptr(), E, C, D, F,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_ffn launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    return y


def report(what: str, got, pre):
    """Histogram of |got - bf16(pre)| in bf16 ulps of bf16(pre)."""
    want = pre.bfloat16().float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)
    u = (got.float() - want).abs() / ulp
    err = (got.float() - want).abs()
    print(json.dumps({
        "compare": what, "values": u.numel(),
        "ulps_0_1_2_3_4plus": [int((u == k).sum()) for k in range(4)]
        + [int((u >= 4).sum())],
        "max_abs_err": float(err.max()),
        "rel_l2": float(err.norm() / want.norm())}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_ffn_rounding: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    silu = torch.nn.functional.silu
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    E, C, D, F = 4, 1024, 2048, 1024

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()
    xs = rand(E, C, D)
    wg, wu = rand(E, D, F, scale=0.02), rand(E, D, F, scale=0.02)
    wd = rand(E, F, D, scale=0.02)
    g, u = torch.bmm(xs.float(), wg.float()), torch.bmm(xs.float(),
                                                        wu.float())
    h = (silu(g) * u).bfloat16().float()
    pre = torch.bmm(h, wd.float())
    for wgmma, bc in ((True, kmoe.WGMMA_ROWS), (False, 32)):
        report(f"y, {'tensor cores' if wgmma else 'fp32 FMA'} vs emulation",
               launch(wgmma, bc, xs, wg, wu, wd), pre)
    # wd = identity: y = h, the first phase alone.
    n = 1024
    xs2, wg2, wu2 = (t[:, :, :n].contiguous() if t is xs
                     else t[:, :n].contiguous() for t in (xs, wg, wu))
    eye = torch.eye(n, device="cuda").bfloat16().expand(E, n, n).contiguous()
    hpre = silu(torch.bmm(xs2.float(), wg2.float())) * torch.bmm(
        xs2.float(), wu2.float())
    for wgmma, bc in ((True, kmoe.WGMMA_ROWS), (False, 32)):
        report(f"h (identity wd), {'tensor cores' if wgmma else 'fp32 FMA'} "
               "vs emulation", launch(wgmma, bc, xs2, wg2, wu2, eye), hpre)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
