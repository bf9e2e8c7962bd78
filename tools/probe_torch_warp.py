'''Phase cycle counts of the warp tile kernel (csrc/warp_tile.cuh) on a GPU:

    python3 tools/probe_torch_warp.py [--plan D:TW:SEG ...]
        [--no-loads] [--no-edges]

It copies the kernel's source with clock64() stamps at six points of a
step (loop top, after the mbarrier wait, after the barrier, after staging
the next step, after the compute, after the stores), builds it with nvcc into build/probe_warp/ beside a small main, and
runs it on warp_twopass's [8, 256, 256, 6] at a random flow past +-d for
each plan (default: the plans of ops/kernels/warp_twopass.py at d = 8 and
18). It prints the kernel's CUDA-event time a call and, for one block,
each step's cycles by phase (the mean over its warps). ``--no-loads``
skips the bulk copies after the first step and ``--no-edges`` the 4-byte
edge copies (the output is then wrong: for timing only), to show what the
copies cost. It imports nothing of JAX.
'''

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, 'dnncancerannotator_torch', 'csrc', 'warp_tile.cuh')
OUT = os.path.join(HERE, 'build', 'probe_warp')

# (anchor in the kernel, text put after it)
STAMPS = (
    ('  for (int k = 0; k < steps; ++k) {\n', '    stamp(k, 0);\n'),
    ('    mbar_wait(bar + (k & 1), (k >> 1) & 1);\n', '    stamp(k, 1);\n'),
    ('    if (leader) bulk_wait<true>();\n    __syncthreads();\n',
     '    stamp(k, 2);\n'),
    ('    stage(k + 1);\n', '    stamp(k, 3);\n'),
    ('      for (int i = sp.e; i < n; ++i) dst[i] = src[i];\n    }\n',
     '    stamp(k, 5);\n'),
)
# (anchor, text put before it)
BEFORE = (('    fence_async_smem();\n    __syncwarp();\n', '    stamp(k, 4);\n'),)

MAIN = r'''
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace dnnca::warp;
int main(int argc, char** argv) {
  const int B = 8, H = 256, W = 256, C = 6, d = atoi(argv[1]),
            tw = atoi(argv[2]), seg = atoi(argv[3]);
  const int th = kThreads / tw, S = std::min(W, tw + 2 * d + 1);
  auto pad4 = [](int n) { return (n + 3) / 4 * 4; };
  const int rb = std::min(H, 2 * th + 2 * d + 1), rs = pad4(S * C + 3),
            fs = 2 * pad4(S + 3), os = pad4(tw * C + 3);
  const int smem = 16 + 4 * (rb * rs + 2 * th * fs + th * os);
  const size_t n = static_cast<size_t>(B) * H * W;
  float *img, *flow, *out;
  long long* st;
  cudaMalloc(&img, n * C * 4);
  cudaMalloc(&flow, n * 2 * 4);
  cudaMalloc(&out, n * C * 4);
  cudaMalloc(&st, 64 * 32 * 8 * 8);
  std::vector<float> h(n * C), hf(n * 2);
  srand(0);
  for (auto& v : h) v = rand() / static_cast<float>(RAND_MAX);
  for (auto& v : hf) v = (rand() / static_cast<float>(RAND_MAX) - 0.5f) * 3 * d;
  cudaMemcpy(img, h.data(), n * C * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(flow, hf.data(), n * 2 * 4, cudaMemcpyHostToDevice);
  auto k = probe_kernel<false, 6, true>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((W + tw - 1) / tw, (H + seg - 1) / seg, B);
  const Frame f{B, H, W, H, W, C};
  const Plan p{tw, seg, th, rb, rs, fs, os};
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 5; ++i)
    k<<<grid, kThreads, smem>>>(img, flow, nullptr, nullptr, out, f, p, d, st);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i)
    k<<<grid, kThreads, smem>>>(img, flow, nullptr, nullptr, out, f, p, d, st);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("d=%d tw=%d seg=%d smem=%d grid=%dx%dx%d: %.4f ms a call (%s)\n",
         d, tw, seg, smem, grid.x, grid.y, grid.z,
         ms / 20, cudaGetErrorString(cudaGetLastError()));
  std::vector<long long> hs(64 * 32 * 8);
  cudaMemcpy(hs.data(), st, hs.size() * 8, cudaMemcpyDeviceToHost);
  const int steps = std::min(64, (std::min(H, seg) + th - 1) / th);
  const int warps = kThreads / 32;
  printf("step   wait   sync  stage compute  store  to-next (cycles, mean"
         " over warps)\n");
  for (int s = 0; s < steps; ++s) {
    double m[6] = {0};
    for (int w = 0; w < warps; ++w) {
      const long long* t = &hs[(s * 32 + w) * 8];
      for (int ph = 0; ph < 5; ++ph)
        m[ph] += (t[ph + 1] - t[ph]) / double(warps);
      if (s + 1 < steps)
        m[5] += (hs[((s + 1) * 32 + w) * 8] - t[5]) / double(warps);
    }
    printf("%4d %6.0f %6.0f %6.0f %7.0f %6.0f %8.0f\n", s, m[0], m[1], m[2],
           m[3], m[4], m[5]);
  }
  return 0;
}
'''


def probe_source(no_loads, no_edges):
    '''The kernel's source with the stamps (and the switches) put in.'''
    src = open(SRC).read()
    body = src[src.index('template <bool kCrop, int kC, bool kPairs>'):
               src.index('template <bool kCrop, int kC>\ncudaError_t')]
    body = body.replace('warp_tile_kernel(', 'probe_kernel(').replace(
        'Frame f, Plan p, int di) {',
        'Frame f, Plan p, int di, long long* st) {\n'
        '  const bool rec = blockIdx.x == 1 && blockIdx.y == 0 && '
        'blockIdx.z == 0 && threadIdx.x % 32 == 0;\n'
        '  auto stamp = [&](int k, int ph) {\n'
        '    if (rec && k < 64) st[(k * 32 + threadIdx.x / 32) * 8 + ph] = '
        'clock64();\n  };')
    edits = [(a, a + t) for a, t in STAMPS]
    edits += [(a, b + a) for a, b in BEFORE]
    if no_loads:
        edits.append(('        if (lane == 0 && sp.e > sp.a) {',
                      '        if (s == 0 && lane == 0 && sp.e > sp.a) {'))
    if no_edges:
        edits.append(('        if ((lane < 4 && i < sp.a) || (lane >= 4 && '
                      'i < g.n))',
                      '        if (false)'))
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f'the kernel changed: {old!r} found '
                               f'{body.count(old)} times')
        body = body.replace(old, new)
    return ('#include "' + SRC + '"\nnamespace dnnca {\nnamespace warp {\n'
            + body + '}  // namespace warp\n}  // namespace dnnca\n' + MAIN)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--plan', nargs='*', default=None,
                        help='D:TW:SEG (default: the wrapper plans)')
    parser.add_argument('--no-loads', action='store_true')
    parser.add_argument('--no-edges', action='store_true')
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    from dnncancerannotator_torch.ops.kernels import _build
    if args.plan is None:
        from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
        args.plan = []
        for d in (8, 18):
            pl = WT.plan(8, 256, 256, 6, d)
            args.plan.append(f'{d}:{pl.tw}:{pl.seg}')
    os.makedirs(OUT, exist_ok=True)
    cu, exe = os.path.join(OUT, 'probe.cu'), os.path.join(OUT, 'probe')
    with open(cu, 'w') as fh:
        fh.write(probe_source(args.no_loads, args.no_edges))
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, '-std=c++17', '-O3',
                    '-o', exe, cu], check=True)
    print(f'loads {"off" if args.no_loads else "on"}, edges '
          f'{"off" if args.no_edges else "on"}', flush=True)
    for plan in args.plan:
        subprocess.run([exe, *plan.split(':')], check=True, timeout=120)


if __name__ == '__main__':
    main()
