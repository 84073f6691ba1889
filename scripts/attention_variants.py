"""Variants of the fp32 tensor-core attention kernels (K1, K3), timed on one
NVIDIA GPU.

    python3 scripts/attention_variants.py [--variants kernel,tf32x1,...] [--iters 100]

Each variant is whmr_tpu_torch/csrc/attention.cu with a few lines replaced
(`VARIANTS`); all are built at once with the package's nvcc flags into
build/attention_variants/, loaded with ctypes and called through the C
entry points on fp32 inputs at the ViT-B head shapes whmr-eval (B=32) and
the forward (B=48) give them. Prints, for each variant, the registers and
spill bytes of its fp32 tensor-core kernels, then K1's and K3's device time
(CUDA events on a stream held by a sleep kernel, variants in turns, twice),
their largest difference from `attention_reference` and whether K3's output
equals K1's. The variants tell apart what the kept design pays for: the
three TF32 products against one (outside the 2e-5 contract, for timing
only), the depth of wgmma steps in flight, K3's warpgroups, V's staging
overlapped with S, and the mma.sync routine at D = 64.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from whmr_tpu_torch.ops import attention as k1  # noqa: E402
from whmr_tpu_torch.ops import cuda_build  # noqa: E402

SRC = ROOT / "whmr_tpu_torch" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "attention_variants"
SHAPES = [(32, 12, 192, 64), (48, 12, 192, 64)]
SLEEP_CYCLES_PER_S = 1.98e9  # chip_smoke.py's: torch.cuda._sleep at the H100's top SM clock

# (old, new) replacements of the source, each of which must match once.
VARIANTS = {
    "kernel": [],
    # One TF32 product (big x big) in place of three, in both routines.
    "tf32x1": [
        ("wgmma_3xtf32_n64(&s[8 * nb][0], cur, dkb + off, dks + off);",
         "wgmma_tf32_rs_n64(&s[8 * nb][0], cur.big, dkb + off);"),
        ("wgmma_3xtf32_n64(o, cur, dvb + off, dvs + off);", "wgmma_tf32_rs_n64(o, cur.big, dvb + off);"),
        ("mma_3xtf32(s[j], a_big, a_small, b_big, b_small);", "mma_tf32(s[j], a_big, b_big);"),
        ("mma_3xtf32(o[nb], a_big, a_small, b_big, b_small);", "mma_tf32(o[nb], a_big, b_big);"),
    ],
    # K1 with one P.V step in flight, as K3.
    "k1_pv_in_flight_1": [("attend_tile_wg<NKP, 2>(q + head", "attend_tile_wg<NKP, 1>(q + head")],
    # K3 with K1's 3 warpgroups and two P.V steps in flight.
    "k3_3_warpgroups": [
        ("static constexpr int kThreads = NKP >= 128 ? 256 : 128;", "static constexpr int kThreads = NKP * 2;"),
        ("attend_tile_wg<NKP, 1>(q + item * head", "attend_tile_wg<NKP, 2>(q + item * head"),
    ],
    # K1 staging V while its S products run (K3 unchanged).
    "stage_v_during_s": [
        ("""template <int NKP, int Threads>
__device__ inline void stage_wg(const float* __restrict__ kh, const float* __restrict__ vh, unsigned char* st,
                                int n, int d) {
  unsigned char* kb = st;
  unsigned char* ks = kb + (size_t)NKP * 256;
  unsigned char* vb = ks + (size_t)NKP * 256;
  unsigned char* vs = vb + (size_t)NKP * 256;
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {""",
         """template <int NKP, int Threads>
__device__ inline void stage_wg_v(const float* __restrict__ vh, unsigned char* st, int n, int d);

template <int NKP, int Threads>
__device__ inline void stage_wg(const float* __restrict__ kh, const float* __restrict__ vh, unsigned char* st,
                                int n, int d) {
  unsigned char* kb = st;
  unsigned char* ks = kb + (size_t)NKP * 256;
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {"""),
        ("""    *reinterpret_cast<uint4*>(ks + off) = small;
  }
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {
    const int c = i / NKP, key = i - c * NKP;""",
         """    *reinterpret_cast<uint4*>(ks + off) = small;
  }
  if (vh != nullptr) stage_wg_v<NKP, Threads>(vh, st, n, d);
}

template <int NKP, int Threads>
__device__ inline void stage_wg_v(const float* __restrict__ vh, unsigned char* st, int n, int d) {
  unsigned char* vb = st + (size_t)NKP * 512;
  unsigned char* vs = vb + (size_t)NKP * 256;
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {
    const int c = i / NKP, key = i - c * NKP;"""),
        ("""template <int NKP, int kPvInFlight>
__device__ inline void attend_tile_wg(const float* __restrict__ qh, const unsigned char* st,""",
         """template <int NKP, int kPvInFlight>
__device__ inline void attend_tile_wg(const float* __restrict__ qh, unsigned char* st, const float* vh,"""),
        ("""    wgmma_commit();
  }
  wgmma_wait<0>();
  a[0].fence();
  a[1].fence();
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {""",
         """    wgmma_commit();
  }
  if (vh != nullptr) {
    stage_wg_v<NKP, NKP * 2>(vh, st, n, d);
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_wait<0>();
  a[0].fence();
  a[1].fence();
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {"""),
        ("""  stage_wg<NKP, NKP * 2>(k + head, v + head, st, N, D);""",
         """  stage_wg<NKP, NKP * 2>(k + head, nullptr, st, N, D);"""),
        ("""attend_tile_wg<NKP, 2>(q + head, st, o + head""", """attend_tile_wg<NKP, 2>(q + head, st, v + head, o + head"""),
        ("""attend_tile_wg<NKP, 1>(q + item * head, st, o + item * head""",
         """attend_tile_wg<NKP, 1>(q + item * head, st, nullptr, o + item * head"""),
    ],
    # fp32 at D <= 64 through the mma.sync routine (the one D > 64 takes).
    "mma_sync_at_64": [("  if (D <= 64) {  // wgmma", "  if (false) {  // wgmma")],
}


def build(names):
    """Each variant's shared library, all compiled at once; prints ptxas's
    registers and spills of its fp32 tensor-core kernels."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name in names:
        text = base
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{text}")
        report = {fn: r for fn, r in cuda_build.ptxas_report(text).items() if "_f32_" in fn}
        print(f"{name}: " + "; ".join(
            f"{fn[fn.index('attention'):fn.index('EE')]}> {r['registers']} registers, "
            f"{r['spill_stores'] + r['spill_loads']} B spilled" for fn, r in sorted(report.items())))
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in (lib.whmr_attention_fwd, lib.whmr_attention_batch_fwd):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(0.2, 1.5 * iters * (time.perf_counter() - t0) + 1e-3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names of VARIANTS")
    parser.add_argument("--iters", type=int, default=100)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(names)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        b, h, n, d = shape
        q, k, v = (torch.randn(*shape, device="cuda", generator=g) for _ in range(3))
        want = k1.attention_reference(q, k, v)
        outs = {name: (torch.empty_like(q), torch.empty_like(q)) for name in names}
        times = {name: ([], []) for name in names}
        for order in (names, names[::-1]):
            for name in order:
                lib = libs[name]
                for i, fwd in enumerate((lib.whmr_attention_fwd, lib.whmr_attention_batch_fwd)):
                    o = outs[name][i]

                    def call():
                        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, n, d,
                                  k1._scale(d), 0, 1, stream)
                        if err != 0:
                            raise RuntimeError(f"variant {name}: launch failed, cudaError {err}")

                    times[name][i].append(cuda_ms(call, args.iters))
        for name in names:
            o1, o3 = outs[name]
            err = max((o1 - want).abs().max().item(), (o3 - want).abs().max().item())
            print(f"{shape} {name}: K1 {[round(t * 1e3, 2) for t in times[name][0]]} us, "
                  f"K3 {[round(t * 1e3, 2) for t in times[name][1]]} us; max_abs_err {err:.3g}; "
                  f"K3 equals K1: {torch.equal(o1, o3)}")


if __name__ == "__main__":
    main()
