'''Phase cycle counts of the stencil backward's one-launch tile kernel
(csrc/stencil_conv_bwd.cu: stencil_tile_bwd_kernel), of the NHWC
stencil conv's tile kernel (csrc/stencil_conv_nhwc.cu:
stencil_nhwc_tile_kernel), or of the NCHW stencil conv's tile kernel
(csrc/stencil_conv.cu: stencil_tile_kernel), on a GPU:

    python3 tools/probe_torch_stencil.py [--shape B:CI:CO:H:W:K] [--bf16]
    python3 tools/probe_torch_stencil.py --nhwc {encoder,head} [--bf16]
    python3 tools/probe_torch_stencil.py --nchw [--shape B:CI:CO:H:W:K]
        [--bf16]

It copies the kernel's source with clock64() stamps at its phases (start,
weights staged, the tile staged, dx, dw and db, the cluster's first sync,
the cluster's partial written, the ticket taken, the finish), builds it
with nvcc into build/probe_stencil/ beside the kernel library's other
sources and a small main, and runs it at unet.yaml + bf16.yaml's
down_2.conv_0 (3x3 SAME, 6 -> 12 at 64 x 64, B=8; ``--shape`` for
another, with the wrapper's tile_plan) in f32 or bf16. It prints the
kernel's CUDA-event time a call, each phase's cycles (mean and largest
over the blocks, the stamps of thread 0), and the spread of the blocks'
start and end times on the device's global timer. ``--nhwc`` probes the
NHWC tile kernel instead at MulmoUNet's encoder conv_0 (3x3 SAME 1 -> 16
with relu, a channel of a [8, 256, 256, 5] batch in f32, a contiguous
channel in bf16) or head (1x1 16 -> 1, B=8) with the wrapper's plan: the
start, the staging (the weights with it), the compute and the output's
staging, the barrier, and the copy of the tile's run. ``--nchw`` probes
the NCHW forward tile at ``--shape`` (3x3 SAME, no relu, as unet.yaml +
leakyReLU.yaml runs its convs; by default down_2.conv_0, 6 -> 12 at 64 x
64, B=8) with the wrapper's plan: the issue of the weights', the
bias's and the input rows' copies, their wait to the barrier, the sums
of thread 0's work items, and their stores.
It imports nothing of JAX.
'''

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, 'dnncancerannotator_torch', 'csrc')
OUT = os.path.join(HERE, 'build', 'probe_stencil')

# (anchor in the tile kernel, stamp index put after it)
AFTER = (
    ('  const float4* gs4 = reinterpret_cast<const float4*>(gs);\n', 0),
    ('    if constexpr (kF32) cp_async_wait_all();\n    __syncthreads();\n',
     2),
    ('  const int cid = blockIdx.x / nc;\n  cluster.sync();\n', 5),
    ('  __threadfence();\n  cluster.sync();\n', 6),
    ('  if (!last) return;\n  __threadfence();\n', 7),
)
# (anchor, stamp index put before it)
BEFORE = (
    ('  const int xplane = lay.xr * lay.xw;\n', 1),
    ('    // dw and db: work unit', 3),
    ('  // the cluster\'s partial: block r', 4),
    ('  if (rank == 0 && tid == 0) *a.ticket = 0u;\n}', 8),
)

MAIN = r'''
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int dnnca_stencil_conv_bwd_tile(
    const float*, const float*, const float*, float*, float*, double*,
    unsigned*, int, int, int, int, int, int, int, int, int, int, int, int,
    int, int, int, int, int, int, void*);
extern "C" int dnnca_stencil_conv_bwd_tile_bf16(
    const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
    __nv_bfloat16*, __nv_bfloat16*, double*, unsigned*, int, int, int, int,
    int, int, int, int, int, int, int, int, int, int, int, int, int, int,
    void*);
int main(int argc, char** argv) {
  const int B = atoi(argv[1]), Ci = atoi(argv[2]), Co = atoi(argv[3]),
            H = atoi(argv[4]), W = atoi(argv[5]), K = atoi(argv[6]),
            rows = atoi(argv[7]), per_block = atoi(argv[8]),
            blocks = atoi(argv[9]), cluster = atoi(argv[10]),
            smem = atoi(argv[11]), n2 = atoi(argv[12]), bf = atoi(argv[13]);
  const int p = K / 2, es = bf ? 2 : 4, vec = W % 4 == 0;
  const size_t nx = size_t(B) * Ci * H * W, ng = size_t(B) * Co * H * W,
               nw = size_t(Co) * Ci * K * K;
  void *x, *g, *w, *dx, *dwb;
  double* partial;
  unsigned* ticket;
  cudaMalloc(&x, nx * es);
  cudaMalloc(&g, ng * es);
  cudaMalloc(&w, nw * es);
  cudaMalloc(&dx, nx * es);
  cudaMalloc(&dwb, (nw + Co) * es);
  cudaMalloc(&partial, size_t(blocks / cluster) * n2 * 8);
  cudaMalloc(&ticket, 4);
  cudaMemset(ticket, 0, 4);
  cudaMemset(x, 0x3c, nx * es);
  cudaMemset(g, 0x3c, ng * es);
  cudaMemset(w, 0x3c, nw * es);
  auto run = [&]() {
    return bf ? dnnca_stencil_conv_bwd_tile_bf16(
                    (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
                    (const __nv_bfloat16*)w, (__nv_bfloat16*)dx,
                    (__nv_bfloat16*)dwb, partial, ticket, B, Ci, Co, H, W, K,
                    K, p, p, H, W, rows, per_block, blocks, cluster, vec,
                    smem, 0, nullptr)
              : dnnca_stencil_conv_bwd_tile(
                    (const float*)x, (const float*)g, (const float*)w,
                    (float*)dx, (float*)dwb, partial, ticket, B, Ci, Co, H,
                    W, K, K, p, p, H, W, rows, per_block, blocks, cluster,
                    vec, smem, 0, nullptr);
  };
  for (int i = 0; i < 5; ++i) run();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("B=%d %d->%d %dx%d K=%d %s rows %d blocks %d cluster %d smem %d: "
         "%.4f ms a call (%s)\n", B, Ci, Co, H, W, K, bf ? "bf16" : "f32",
         rows, blocks, cluster, smem, ms / 20,
         cudaGetErrorString(cudaGetLastError()));
  cudaMemset(probe_ptr(), 0, sizeof(long long) * kProbeBlocks * 16);
  run();
  cudaDeviceSynchronize();
  std::vector<long long> st(kProbeBlocks * 16);
  cudaMemcpy(st.data(), probe_ptr(), st.size() * 8, cudaMemcpyDeviceToHost);
  const int nb = std::min(blocks, kProbeBlocks);
  const char* names[] = {"weights", "stage", "dx", "dw", "cluster sync",
                         "cluster sum", "ticket", "finish"};
  for (int ph = 0; ph < 8; ++ph) {
    double sum = 0;
    long long most = 0;
    int n = 0;
    for (int k = 0; k < nb; ++k) {
      const long long* t = &st[k * 16];
      if (t[ph] == 0 || t[ph + 1] == 0) continue;
      sum += t[ph + 1] - t[ph];
      most = std::max(most, t[ph + 1] - t[ph]);
      ++n;
    }
    printf("  %-12s %8.0f cycles mean, %8lld most (%d blocks)\n", names[ph],
           n ? sum / n : 0.0, most, n);
  }
  long long s0 = 1LL << 62, s1 = 0, e0 = 1LL << 62, e1 = 0;
  for (int k = 0; k < nb; ++k) {
    s0 = std::min(s0, st[k * 16 + 10]);
    s1 = std::max(s1, st[k * 16 + 10]);
    if (st[k * 16 + 11]) {
      e0 = std::min(e0, st[k * 16 + 11]);
      e1 = std::max(e1, st[k * 16 + 11]);
    }
  }
  printf("  global timer: starts spread %.2f us, ends %.2f-%.2f us after "
         "the first start\n", (s1 - s0) / 1e3, (e0 - s0) / 1e3,
         (e1 - s0) / 1e3);
  return 0;
}
'''

PRELUDE = r'''
constexpr int kProbeBlocks = 1024;
__device__ long long g_probe[kProbeBlocks * 16];
static void* probe_ptr() {
  void* p;
  cudaGetSymbolAddress(&p, g_probe);
  return p;
}
__device__ __forceinline__ long long probe_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i)                                                 \
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {            \
    g_probe[blockIdx.x * 16 + (i)] = clock64();                   \
    if ((i) == 0) g_probe[blockIdx.x * 16 + 10] = probe_now();    \
    if ((i) == 4) g_probe[blockIdx.x * 16 + 11] = probe_now();    \
  }
'''


NHWC_AFTER = (
    ('  const int nr = min(a.rows, a.OH - oy0);   // output rows of the tile\n',
     0),
    ('  if constexpr (kF32) cp_async_wait_all();\n  __syncthreads();\n', 2),
)
NHWC_STAGE = '  // the input rows oy0 - pt + [0, in_rows)'   # STAMP(1) before
# the barrier before the copy of the output: STAMP(3) before it, (4) after
NHWC_BARRIER = ('  __syncthreads();\n\n  // the tile\'s run of n_out values',
                '  __syncthreads();\n  STAMP(4);\n\n  // the tile\'s run of '
                'n_out values')
NHWC_END = ('          run[e] = out_s[e];\n      }\n    }\n  }\n',
            '  STAMP(5);\n')

NHWC_MAIN = r'''
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int dnnca_stencil_conv_nhwc(const float*, const float*,
    const float*, float*, int, int, int, int, int, int, int, int, int, int,
    int, int, int, int, int, int, int, int, void*);
extern "C" int dnnca_stencil_conv_nhwc_bf16(const __nv_bfloat16*,
    const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int,
    int, int, int, int, int, int, int, int, int, int, int, int, int, int,
    int, int, void*);
int main(int argc, char** argv) {
  const int B = atoi(argv[1]), H = atoi(argv[2]), W = atoi(argv[3]),
            Ci = atoi(argv[4]), Co = atoi(argv[5]), K = atoi(argv[6]),
            xs = atoi(argv[7]), rows = atoi(argv[8]),
            vec_out = atoi(argv[9]), tiles = atoi(argv[10]),
            bf = atoi(argv[11]);
  const int p = K / 2, es = bf ? 2 : 4, relu = K == 3;
  const int vec_in = Ci % 4 == 0 && xs % 4 == 0;
  const size_t nx = size_t(B) * H * W * xs, no = size_t(B) * H * W * Co;
  void *x, *w, *bias, *out;
  cudaMalloc(&x, nx * es);
  cudaMalloc(&w, size_t(Co) * Ci * K * K * es);
  cudaMalloc(&bias, Co * es);
  cudaMalloc(&out, no * es);
  cudaMemset(x, 0x3c, nx * es);
  cudaMemset(w, 0x3c, size_t(Co) * Ci * K * K * es);
  cudaMemset(bias, 0, Co * es);
  auto run = [&]() {
    return bf ? dnnca_stencil_conv_nhwc_bf16(
                    (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                    (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, B, Ci,
                    Co, H, W, xs, K, K, p, p, H, W, relu, vec_in, 1, rows,
                    vec_out, 0, nullptr)
              : dnnca_stencil_conv_nhwc(
                    (const float*)x, (const float*)w, (const float*)bias,
                    (float*)out, B, Ci, Co, H, W, xs, K, K, p, p, H, W, relu,
                    vec_in, 1, rows, vec_out, 0, nullptr);
  };
  for (int i = 0; i < 5; ++i) run();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("B=%d %dx%d %d->%d K=%d xs=%d %s rows %d vec_out %d tiles %d: "
         "%.4f ms a call (%s)\n", B, H, W, Ci, Co, K, xs, bf ? "bf16" : "f32",
         rows, vec_out, tiles, ms / 20,
         cudaGetErrorString(cudaGetLastError()));
  cudaMemset(probe_ptr(), 0, sizeof(long long) * kProbeBlocks * 16);
  run();
  cudaDeviceSynchronize();
  std::vector<long long> st(kProbeBlocks * 16);
  cudaMemcpy(st.data(), probe_ptr(), st.size() * 8, cudaMemcpyDeviceToHost);
  const char* names[] = {"start", "stage", "compute", "barrier",
                         "copy out"};
  const int nb = tiles < kProbeBlocks ? tiles : kProbeBlocks;
  for (int ph = 0; ph < 5; ++ph) {
    double sum = 0;
    long long most = 0;
    for (int k = 0; k < nb; ++k) {
      const long long d = st[k * 16 + ph + 1] - st[k * 16 + ph];
      sum += d;
      most = d > most ? d : most;
    }
    printf("  %-10s %8.0f cycles mean, %8lld most (%d blocks)\n",
           names[ph], sum / nb, most, nb);
  }
  long long s0 = 1LL << 62, e1 = 0;
  for (int k = 0; k < nb; ++k) {
    s0 = st[k * 16 + 10] < s0 ? st[k * 16 + 10] : s0;
    e1 = st[k * 16 + 11] > e1 ? st[k * 16 + 11] : e1;
  }
  printf("  global timer: the first %d blocks from the first start to the "
         "last end %.2f us\n", nb, (e1 - s0) / 1e3);
  return 0;
}
'''


NCHW_BIAS = '  dnnca::tile::stage_bias<T>(bs, a.bias, a.Co, CPT, groups);\n'
NCHW_ROWS = '  const T* xb = a.x + static_cast<size_t>(b) * a.Ci * in_plane;\n'
NCHW_WAIT = '  dnnca::tile::cp_async_wait_all();\n  __syncthreads();\n'
NCHW_STORE = ('#pragma unroll\n    for (int o = 0; o < CPT; ++o) {\n'
              '      if (g * CPT + o >= a.Co) break;')
NCHW_END = ('                    v, a.OW - col);\n    }\n  }\n}\n')

NCHW_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int dnnca_stencil_conv_tile(const float*, const float*,
    const float*, float*, int, int, int, int, int, int, int, int, int, int,
    int, int, int, int, int, int, int, int, int, int, int, int, void*);
extern "C" int dnnca_stencil_conv_tile_bf16(const __nv_bfloat16*,
    const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int,
    int, int, int, int, int, int, int, int, int, int, int, int, int, int,
    int, int, int, int, int, int, void*);
int main(int argc, char** argv) {
  int v[17];
  for (int i = 0; i < 17; ++i) v[i] = atoi(argv[i + 1]);
  const int B = v[0], Ci = v[1], Co = v[2], H = v[3], W = v[4], K = v[5],
            cpt = v[6], px = v[7], ri = v[8], rows = v[9], cols = v[10],
            xs_w = v[11], ks = v[12], threads = v[13], smem = v[14],
            blocks = v[15], bf = v[16];
  const int p = K / 2, es = bf ? 2 : 4;
  const size_t nx = size_t(B) * Ci * H * W, no = size_t(B) * Co * H * W,
               nw = size_t(Co) * Ci * K * K;
  void *x, *w, *bias, *out;
  cudaMalloc(&x, nx * es);
  cudaMalloc(&w, nw * es);
  cudaMalloc(&bias, Co * es);
  cudaMalloc(&out, no * es);
  cudaMemset(x, 0x3c, nx * es);
  cudaMemset(w, 0x3c, nw * es);
  cudaMemset(bias, 0, Co * es);
  auto run = [&]() {
    return bf ? dnnca_stencil_conv_tile_bf16(
                    (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                    (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, B, Ci,
                    Co, H, W, K, K, p, p, H, W, 0, cpt, px, ri, rows, cols,
                    xs_w, ks, threads, smem, 0, nullptr)
              : dnnca_stencil_conv_tile(
                    (const float*)x, (const float*)w, (const float*)bias,
                    (float*)out, B, Ci, Co, H, W, K, K, p, p, H, W, 0, cpt,
                    px, ri, rows, cols, xs_w, ks, threads, smem, 0, nullptr);
  };
  for (int i = 0; i < 5; ++i) run();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("B=%d %d->%d %dx%d K=%d %s cpt %d px %d ks %d rows %d threads %d "
         "blocks %d smem %d: %.4f ms a call (%s)\n", B, Ci, Co, H, W, K,
         bf ? "bf16" : "f32", cpt, px, ks, rows, threads, blocks, smem,
         ms / 20, cudaGetErrorString(cudaGetLastError()));
  cudaMemset(probe_ptr(), 0, sizeof(long long) * kProbeBlocks * 16);
  run();
  cudaDeviceSynchronize();
  std::vector<long long> st(kProbeBlocks * 16);
  cudaMemcpy(st.data(), probe_ptr(), st.size() * 8, cudaMemcpyDeviceToHost);
  const char* names[] = {"weights", "bias", "rows", "wait", "compute",
                         "store"};
  const int nb = blocks < kProbeBlocks ? blocks : kProbeBlocks;
  for (int ph = 0; ph < 6; ++ph) {
    double sum = 0;
    long long most = 0;
    for (int k = 0; k < nb; ++k) {
      const long long d = st[k * 16 + ph + 1] - st[k * 16 + ph];
      sum += d;
      most = d > most ? d : most;
    }
    printf("  %-10s %8.0f cycles mean, %8lld most (%d blocks)\n",
           names[ph], sum / nb, most, nb);
  }
  long long s0 = 1LL << 62, s1 = 0, e0 = 1LL << 62, e1 = 0;
  for (int k = 0; k < nb; ++k) {
    s0 = st[k * 16 + 10] < s0 ? st[k * 16 + 10] : s0;
    s1 = st[k * 16 + 10] > s1 ? st[k * 16 + 10] : s1;
    e0 = st[k * 16 + 11] < e0 ? st[k * 16 + 11] : e0;
    e1 = st[k * 16 + 11] > e1 ? st[k * 16 + 11] : e1;
  }
  printf("  global timer: starts spread %.2f us, ends %.2f-%.2f us after "
         "the first start (the first %d blocks)\n", (s1 - s0) / 1e3,
         (e0 - s0) / 1e3, (e1 - s0) / 1e3, nb);
  return 0;
}
"""


def nchw_probe_source():
    '''stencil_conv.cu with the stamps put into the tile kernel: 0 at its
    start, 1 when the weights' copies are issued, 2 the bias's, 3 the
    rows', 4 when they have landed, 5 before thread 0's last work item
    stores, 6 at its end.'''
    src = open(os.path.join(CSRC, 'stencil_conv.cu')).read()
    start = src.index('stencil_tile_kernel(TileArgs<T> a) {')
    end = src.index('template <int CPT, int PX, typename T>\n'
                    'cudaError_t launch_tile')
    body = src[start:end]
    first = 'stencil_tile_kernel(TileArgs<T> a) {\n'
    edits = [(first, first + '  STAMP(0);\n'),
             (NCHW_BIAS, '  STAMP(1);\n' + NCHW_BIAS),
             (NCHW_ROWS, '  STAMP(2);\n' + NCHW_ROWS),
             (NCHW_WAIT, '  STAMP(3);\n' + NCHW_WAIT + '  STAMP(4);\n'),
             (NCHW_STORE, '    STAMP(5);\n' + NCHW_STORE),
             (NCHW_END, NCHW_END[:-2] + '  STAMP(6);\n}\n')]
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f'the kernel changed: {old!r} found '
                               f'{body.count(old)} times')
        body = body.replace(old, new)
    head = src[:start].replace('#include "conv_tile.cuh"',
                               '#include "conv_tile.cuh"\n' + PRELUDE, 1)
    return (head + body + src[end:] + NCHW_MAIN).replace(
        'if ((i) == 4) g_probe', 'if ((i) == 6) g_probe')

def nhwc_probe_source():
    '''stencil_conv_nhwc.cu with the stamps put into the tile kernel.'''
    src = open(os.path.join(CSRC, 'stencil_conv_nhwc.cu')).read()
    start = src.index('stencil_nhwc_tile_kernel(const TileArgs<T> a) {')
    end = src.index('template <int CO, int KX, typename T>\n'
                    'cudaError_t launch_tile')
    body = src[start:end]
    edits = [(a, a + f'  STAMP({i});\n') for a, i in NHWC_AFTER]
    edits.append(NHWC_BARRIER)
    edits += [(NHWC_STAGE, '  STAMP(1);\n' + NHWC_STAGE),
              (NHWC_BARRIER[1], '  STAMP(3);\n' + NHWC_BARRIER[1])]
    edits.append((NHWC_END[0], NHWC_END[0] + NHWC_END[1]))
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f'the kernel changed: {old!r} found '
                               f'{body.count(old)} times')
        body = body.replace(old, new)
    head = src[:start].replace('#include "conv_tile.cuh"',
                               '#include "conv_tile.cuh"\n' + PRELUDE, 1)
    return (head + body + src[end:] + NHWC_MAIN).replace(
        'if ((i) == 4) g_probe', 'if ((i) == 5) g_probe')


def probe_source():
    '''stencil_conv_bwd.cu with the stamps put into the tile kernel.'''
    src = open(os.path.join(CSRC, 'stencil_conv_bwd.cu')).read()
    start = src.index('stencil_tile_bwd_kernel(const TileArgs<T> a) {')
    end = src.index('template <int CI, int CO, typename T>\ncudaError_t '
                    'launch_tile')
    body = src[start:end]
    edits = [(a, a + f'  STAMP({i});\n') for a, i in AFTER]
    edits += [(a, f'  STAMP({i});\n' + a) for a, i in BEFORE]
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f'the kernel changed: {old!r} found '
                               f'{body.count(old)} times')
        body = body.replace(old, new)
    head = src[:start].replace('#include "conv_tile.cuh"',
                               '#include "conv_tile.cuh"\n' + PRELUDE, 1)
    return head + body + src[end:] + MAIN


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--shape', default='8:6:12:64:64:3',
                        help='B:CI:CO:H:W:K (SAME pads)')
    parser.add_argument('--bf16', action='store_true')
    parser.add_argument('--nhwc', choices=('encoder', 'head'), default=None)
    parser.add_argument('--nchw', action='store_true',
                        help='probe the NCHW forward tile at --shape')
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    from dnncancerannotator_torch.ops.kernels import _build
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    os.makedirs(OUT, exist_ok=True)
    if args.nhwc:
        ci, co, k = (1, 16, 3) if args.nhwc == 'encoder' else (16, 1, 1)
        xs = 5 if args.nhwc == 'encoder' and not args.bf16 else ci
        pads = ((k // 2, k // 2), (k // 2, k // 2))
        pl = SN.plan(8, 256, 256, ci, co, k, k, pads, 2 if args.bf16 else 4)
        cu, exe = os.path.join(OUT, 'nhwc.cu'), os.path.join(OUT, 'nhwc')
        with open(cu, 'w') as fh:
            fh.write(nhwc_probe_source())
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, '-std=c++17',
                        '-O3', f'-I{CSRC}', '-o', exe, cu,
                        os.path.join(CSRC, 'common.cu')], check=True)
        subprocess.run([exe, *(str(v) for v in (
            8, 256, 256, ci, co, k, xs, pl.rows, int(pl.vec_out), pl.tiles,
            int(args.bf16)))], check=True, timeout=120)
        return
    b, ci, co, h, w, k = (int(v) for v in args.shape.split(':'))
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    if args.nchw:
        pl = SC.plan(b, ci, co, h, w, k, k, pads)
        cu, exe = os.path.join(OUT, 'nchw.cu'), os.path.join(OUT, 'nchw')
        with open(cu, 'w') as fh:
            fh.write(nchw_probe_source())
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, '-std=c++17',
                        '-O3', f'-I{CSRC}', '-o', exe, cu,
                        os.path.join(CSRC, 'common.cu')], check=True)
        subprocess.run([exe, *(str(v) for v in (
            b, ci, co, h, w, k, pl.cpt, pl.px, pl.ri, pl.rows, pl.cols,
            pl.xs_w, pl.ks, pl.threads, pl.smem, pl.blocks,
            int(args.bf16)))],
            check=True, timeout=120)
        return
    pl = SCB.tile_plan(b, ci, co, h, w, k, k, pads)
    cu, exe = os.path.join(OUT, 'probe.cu'), os.path.join(OUT, 'probe')
    with open(cu, 'w') as fh:
        fh.write(probe_source())
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, '-std=c++17', '-O3',
                    f'-I{CSRC}', '-o', exe, cu,
                    os.path.join(CSRC, 'common.cu'),
                    os.path.join(CSRC, 'wgrad.cu')], check=True)
    subprocess.run([exe, *(str(v) for v in (
        b, ci, co, h, w, k, pl.rows, pl.per_block, pl.blocks, pl.cluster,
        pl.smem, pl.n2, int(args.bf16)))], check=True, timeout=120)


if __name__ == '__main__':
    main()
