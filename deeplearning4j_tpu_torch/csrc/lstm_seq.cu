// LSTM over a whole TBPTT segment for Hopper (sm_90a): T steps of the fused cell in one launch,
// U resident in a thread-block cluster's shared memory, h exchanged through distributed shared
// memory, bf16 products on the tensor cores.
//
// Replaces the TPU kernel of the JAX package composed over a segment:
//   deeplearning4j_tpu/ops/kernels/lstm.py::_cell_kernel (launched by _cell_pallas), as
//   lstm_sequence_fused's lax.scan and nn/recurrent.py's layer scan (_scan, :80-101) run it once
//   per step. The TPU program re-reads U every step from HBM into VMEM; here a segment reads it
//   once.
//
// What it computes, for xp (B, T, 4H) (the layer's input projection plus bias, rows and steps at
// given strides, each row's 4H contiguous), h0 and c0 (B, H), U (H, 4H), an optional mask (B, T),
// all of one type T (fp32 or bf16). For t = 0..T-1, with h_{-1} = h0 and c_{-1} = c0:
//   z = xp[:, t] + h_{t-1} @ U in fp32; i, f, o = sigmoid, g = tanh of the column blocks the gate
//   order names (col_i, col_f, col_o, col_g); c' = f * c_{t-1} + i * g, h' = o * tanh(c');
//   h' and c' rounded to T, as the reference's cell returns them (_cell_fwd_impl);
//   no mask: h_t = h', c_t = c', y_t = h'; with a mask m = mask[:, t] (any value, not only 0/1):
//   h_t = m * h' + (1 - m) * h_{t-1}, c_t likewise, y_t = m * h', each operation rounded to T as
//   _scan's PyTorch ops round it (lstm_common.cuh's blend). f * c + i * g is two products and a
//   sum, each rounded, as the plain version's ops compute it (no FMA contraction).
// Written: y (B, T, H), the c carry of every step (B, T, H), under a mask the h carry of every
// step (B, T, H) (y is not the h carry there), and the final (h, c) (B, H). The backward
// (ops/kernels/lstm.py::LSTMSequenceFunction) reads the carries.
//
// Two bodies, picked by pick_body (mirrored by ops/kernels/lstm.py::seq_body):
//   - resident (this file): H a multiple of CLUSTER * 16, J = H / CLUSTER at most MAX_UNITS and
//     the block's shared memory within SMEM_MAX (resident_smem): H 256 and 512 in bf16, H 256 in
//     fp32, at any batch;
//   - step: lstm_cell.cu's step kernel, launched once per step (dl4j_lstm_step_launch) with the
//     states read and written in place in the (B, T, H) outputs, then the final state copied.
//
// The resident body. A cluster of CLUSTER blocks carries up to ROWS batch rows (more rows: more
// clusters, each independent of the others: B 32 runs as four clusters on 64 SMs;
// tools/lstm_ablation.py measured 16 and 32 rows a cluster, and clusters of 8 blocks, slower);
// block r of a cluster owns the hidden units [r*J, (r+1)*J), J = H / CLUSTER, and so the 4J
// columns of z at q*H + r*J + j (q = 0..3):
//   - U: the block's 4J columns of U (H x 4J) are copied into shared memory once per launch
//     (each (row k, column block q) run of J values by 16-byte cp.async pieces), row k at
//     UROW bytes, its 16-byte chunks XOR-swizzled by k & 7 so that eight rows of one chunk fall in
//     distinct banks. U is not read from device memory again during the segment.
//   - h: every block holds all of h_{t-1} (H x R, k-major: row k holds h[b, k] for the cluster's
//     R rows, chunks swizzled so that ldmatrix's eight rows are conflict-free), in two buffers:
//     step t reads buffer t & 1 and writes h_t into buffer (t + 1) & 1 of every block of the
//     cluster, its own included, by st.shared::cluster (distributed shared memory). One cluster
//     barrier (arrive.release / wait.acquire) a step publishes those stores; a block writes
//     buffer (t + 1) & 1 only after every block has passed step t - 1's barrier, so after it has
//     finished reading h_{t-2} there. The slice goes out as 16-byte chunks, staged whole in
//     shared memory first.
//   - bf16 products: mma.sync m16n8k16 with the block's 4J gate columns as M (one m16 tile of
//     each column block a warp, two where J is 32), the cluster's rows as N (n8 tiles) and K = H.
//     U's k-major rows are A through ldmatrix.trans, h's k-major rows B through ldmatrix.trans;
//     fp32 sums. The eight warps are four column blocks x two halves of K.
//   - fp32 products: FMA on the CUDA cores (TF32 would break the port's fp32 parity); a thread
//     owns 4 gate columns x 4 rows over one slice of K, as many slices as give every thread a
//     tile (8 at 8 rows), U and h read as float4.
//   - The slices' partial sums meet in shared memory, a buffer each, and the epilogue adds them
//     in slice order, so a launch is deterministic. The epilogue: each thread keeps its (unit,
//     row) pairs' c and h in registers for the whole segment, adds xp (loaded a step ahead, so its
//     latency hides behind a step), runs the gates, rounds, applies the mask, and stores y, the
//     carries and the block's slice of h_t.
//   - The first cluster barrier follows the U and h0 loads (no block writes into a peer that has
//     not started); the last step pushes nothing, and a final cluster barrier keeps every block
//     resident until no peer can write into its shared memory.
//
// What bounds it. A segment at the char-RNN's geometry (B 32, H 256, T 50) does 2 * B * H * 4H * T
// = 839 MFLOP on 10.9 MB (fp32; 5.5 MB in bf16): 12.5 us of fp32 FMA at 67 TFLOP/s, bound by
// operations; 1.6 us of bytes in bf16 (0.85 us of tensor-core operations at 989 TFLOP/s). The
// steps are serial, so the kernel is bound by each step's latency: the products (fp32: 8.4 M FMA
// a step over the four clusters' 64 SMs), the epilogue's sigmoid/tanh chain, the exchange and the
// barrier.
// tools/lstm_ablation.py times it with each of those cut out (PERF.md).

#include <atomic>

#include "hopper.cuh"
#include "lstm_common.cuh"

namespace {

constexpr int CLUSTER = 16;          // blocks of a cluster (non-portable above 8)
constexpr int ROWS = 8;              // batch rows a cluster carries at most
constexpr int SEQ_THREADS = 256;     // eight warps
constexpr int MAX_UNITS = 32;        // hidden units a block owns at most (J)
constexpr int SMEM_MAX = 232448;     // dynamic shared memory of one block on sm_90 (227 KB)
constexpr int BODY_STEP = 0, BODY_RESIDENT = 1;

struct SeqArgs {
  const void* xp;
  const void* h0;
  const void* c0;
  const void* u;
  const void* mask;  // (B, T) contiguous, or nullptr
  void* y;           // (B, T, H)
  void* hseq;        // (B, T, H), written only with a mask
  void* cseq;        // (B, T, H)
  void* h_fin;       // (B, H)
  void* c_fin;       // (B, H)
  int b, h, steps;
  long long xp_sb, xp_st;  // xp's row and step strides, in elements
  int col_i, col_f, col_o, col_g;
};

// rows a cluster carries for a batch of b: a power of two from 8 (one n8 tile) to ROWS (the
// kernel is written for 8, 16 and 32)
inline int rows_per_cluster(int b) {
  int r = 8;
  while (r < b && r < ROWS) r <<= 1;
  return r;
}

// slices of K whose partial sums meet in the z exchange: the two halves of the bf16 warps; for
// fp32 as many as give each thread one tile of 4 gate columns x 4 rows (J x R / 4 tiles)
__host__ __device__ inline int k_slices(int es, int j, int r) {
  return es == 2 ? 2 : SEQ_THREADS * 4 / (j * r);
}

// dynamic shared memory of one resident block: U's slice, two h buffers, the z exchange (a
// slice of fp32 partial sums per slice of K) and the block's h slice
inline long long resident_smem(int es, int h, int r) {
  const long long j = h / CLUSTER;
  return (long long)h * 4 * j * es + 2LL * h * r * es +
         (long long)k_slices(es, (int)j, r) * r * (4 * j + 4) * 4 + j * r * es;
}

int pick_body(int dtype, int b, int h) {
  if ((dtype != 0 && dtype != 1) || h % (CLUSTER * 16) != 0 || h / CLUSTER > MAX_UNITS)
    return BODY_STEP;
  const int es = dtype == 0 ? 4 : 2;
  return resident_smem(es, h, rows_per_cluster(b)) <= SMEM_MAX ? BODY_RESIDENT : BODY_STEP;
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// `addr` in this block's shared memory, as the same offset in cluster block `rank`'s
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// every thread of every block of the cluster: stores before it are seen by loads after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 16-byte chunk of row k of an h buffer (W chunks a row) where logical chunk c lies: eight
// consecutive rows of one chunk land in eight distinct bank groups
template <int W>
__device__ __forceinline__ int hsw(int k, int c) {
  if constexpr (W >= 8)
    return c ^ (k & 7);
  else if constexpr (W == 1)
    return c;
  else
    return c ^ ((k / (8 / W)) & (W - 1));
}

// U's 4J columns of this block into shared memory (row k at urow bytes, chunk c at c ^ (k & 7))
template <typename T>
__device__ __forceinline__ void stage_u(uint32_t us, const T* __restrict__ u, int H, int J,
                                        int j0, int urow) {
  constexpr int PER = 16 / sizeof(T);        // elements a chunk
  const int runs = J / PER;                  // chunks of one (k, q) run
  const int total = H * 4 * runs;
  for (int e = threadIdx.x; e < total; e += SEQ_THREADS) {
    const int c = e % (4 * runs), k = e / (4 * runs);
    const int q = c / runs, part = c % runs;
    const T* src = u + (long long)k * 4 * H + (long long)q * H + j0 + part * PER;
    cp_async16(us + k * urow + ((c ^ (k & 7)) << 4), src, true);
  }
}

// xp and the mask of step t for this thread's (unit, row) pairs of the epilogue
template <typename T, int PMAX>
__device__ __forceinline__ void load_step(const SeqArgs& a, int t, int J, int j0, int b_base,
                                          int rows, float (&x)[PMAX][4], float (&m)[PMAX]) {
  const T* __restrict__ xp = static_cast<const T*>(a.xp);
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    const int p = threadIdx.x + i * SEQ_THREADS, j = p % J, bl = p / J;
    m[i] = 1.f;
    if (bl < rows) {
      const T* xr = xp + (long long)(b_base + bl) * a.xp_sb + (long long)t * a.xp_st + j0 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[i][q] = to_f(xr[(long long)q * a.h]);
      if (a.mask != nullptr)
        m[i] = to_f(static_cast<const T*>(a.mask)[(long long)(b_base + bl) * a.steps + t]);
    }
  }
}

template <typename T, int R, int MT>
__global__ void __launch_bounds__(SEQ_THREADS, 1) lstm_seq_resident(const SeqArgs a) {
  constexpr int ES = sizeof(T);
  constexpr int HROW = R * ES;               // bytes of one row of an h buffer
  constexpr int W = HROW / 16;               // its chunks
  constexpr int NT = R / 8;                  // n8 tiles (bf16)
  constexpr int PMAX = (MAX_UNITS * R + SEQ_THREADS - 1) / SEQ_THREADS;  // pairs a thread
  extern __shared__ __align__(16) uint8_t smem[];

  const int H = a.h, J = H / CLUSTER, steps = a.steps;
  const int UROW = 4 * J * ES, ZW = 4 * J + 4;  // ZW: floats of a z row (+4: no bank conflict)
  const int slices = k_slices(ES, J, R);
  uint8_t* us_p = smem;
  uint8_t* hb_p = us_p + (size_t)H * UROW;
  float* zs = reinterpret_cast<float*>(hb_p + 2 * (size_t)H * HROW);  // [slice][row][column]
  uint8_t* hl_p = reinterpret_cast<uint8_t*>(zs + slices * R * ZW);
  const uint32_t us = smem_u32(us_p), hb = smem_u32(hb_p);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank();
  const int j0 = rank * J;
  const int b_base = (blockIdx.x / CLUSTER) * R;
  const int rows = min(R, a.b - b_base);     // real rows of this cluster
  const long long TH = (long long)steps * H;

  // U's slice (async), h0 into buffer 0 (zero rows past the batch), the slice staging zeroed
  stage_u<T>(us, static_cast<const T*>(a.u), H, J, j0, UROW);
  for (int e = tid; e < H * R; e += SEQ_THREADS) {
    const int bl = e / H, k = e % H;
    const T v = bl < rows ? static_cast<const T*>(a.h0)[(long long)(b_base + bl) * H + k]
                          : from_f<T>(0.f);
    *reinterpret_cast<T*>(hb_p + k * HROW + (hsw<W>(k, bl * ES / 16) << 4) + (bl * ES) % 16) =
        v;
  }
  for (int e = tid; e < J * HROW / 4; e += SEQ_THREADS) reinterpret_cast<uint32_t*>(hl_p)[e] = 0u;
  float hreg[PMAX], creg[PMAX];
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    const int p = tid + i * SEQ_THREADS, j = p % J, bl = p / J;
    hreg[i] = creg[i] = 0.f;
    if (bl < rows) {
      const long long at = (long long)(b_base + bl) * H + j0 + j;
      hreg[i] = to_f(static_cast<const T*>(a.h0)[at]);
      creg[i] = to_f(static_cast<const T*>(a.c0)[at]);
    }
  }
  float xn[PMAX][4], mn[PMAX];
  load_step<T, PMAX>(a, 0, J, j0, b_base, rows, xn, mn);
  cp_async_wait_all();
  cluster_barrier();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    // this step's xp and mask, loaded a step ahead; the next step's go out now
    float xv[PMAX][4], mv[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      mv[i] = mn[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[i][q] = xn[i][q];
    }
    if (t + 1 < steps) load_step<T, PMAX>(a, t + 1, J, j0, b_base, rows, xn, mn);

    const uint32_t hcur = hb + cur * H * HROW;
    if constexpr (ES == 2) {
      // warp: column block q = warp & 3, half kh = warp >> 2 of K (slice kh of zs)
      const int q = warp & 3, kh = warp >> 2, ks_n = H / 32;
      const int lr = lane & 7, lq = lane >> 3;
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      for (int s = 0; s < ks_n; ++s) {
        const int k0 = (kh * ks_n + s) * 16;
        uint32_t af[MT][4], bf[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int k = k0 + lr + ((lq >> 1) << 3);
          const int m = q * J + mt * 16 + ((lq & 1) << 3);
          ldsm_x4_t(af[mt], us + k * UROW + (((m >> 3) ^ (k & 7)) << 4));
        }
        const int kb = k0 + lr + ((lq & 1) << 3);
        if constexpr (NT == 1) {
          ldsm_x2_t(bf[0], hcur + kb * HROW + (hsw<W>(kb, 0) << 4));
        } else {
#pragma unroll
          for (int pr = 0; pr < NT / 2; ++pr) {
            uint32_t r4[4];
            ldsm_x4_t(r4, hcur + kb * HROW + (hsw<W>(kb, pr * 2 + (lq >> 1)) << 4));
            bf[2 * pr][0] = r4[0];
            bf[2 * pr][1] = r4[1];
            bf[2 * pr + 1][0] = r4[2];
            bf[2 * pr + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bf[nt]);
      }
      float* zk = zs + kh * R * ZW;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            zk[(nt * 8 + 2 * (lane & 3) + (e & 1)) * ZW + q * J + mt * 16 + (lane >> 2) +
               (e >> 1) * 8] = acc[mt][nt][e];
    } else {
      // a thread: 4 gate columns (4 mg..) x 4 rows (4 bg..) over slice ks of K; 8 rows of K a
      // pass, whose swizzled offsets depend on the row's k & 7 only
      const int tiles = J * (R / 4), tile = tid % tiles, ks = tid / tiles;
      const int mg = tile % J, bg = tile / J, klen = H / slices;
      float acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
      int uoff[8], hoff[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uoff[kk] = kk * UROW + ((mg ^ kk) << 4);
        hoff[kk] = kk * HROW + (hsw<W>(kk, bg) << 4);
      }
      const uint8_t* up = us_p + (size_t)ks * klen * UROW;
      const uint8_t* hp = hb_p + (size_t)cur * H * HROW + (size_t)ks * klen * HROW;
      for (int o = 0; o < klen / 8; ++o, up += 8 * UROW, hp += 8 * HROW) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float4 uv = *reinterpret_cast<const float4*>(up + uoff[kk]);
          const float4 hv = *reinterpret_cast<const float4*>(hp + hoff[kk]);
          const float uu[4] = {uv.x, uv.y, uv.z, uv.w}, hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(uu[x], hh[y], acc[x][y]);
        }
      }
      float* zk = zs + ks * R * ZW;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<float4*>(zk + (bg * 4 + y) * ZW + mg * 4) =
            make_float4(acc[0][y], acc[1][y], acc[2][y], acc[3][y]);
    }
    __syncthreads();

    // epilogue: the slices' partial sums in slice order, xp, the gates and the state update of
    // this thread's (unit, row) pairs
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const int p = tid + i * SEQ_THREADS, j = p % J, bl = p / J;
      if (bl >= rows) continue;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* zp = zs + bl * ZW + q * J + j;
        float sum = zp[0];
        for (int s = 1; s < slices; ++s) sum += zp[s * R * ZW];
        z[q] = xv[i][q] + sum;
      }
      const float ig = sigmoid_acc(pick(z, a.col_i));
      const float fg = sigmoid_acc(pick(z, a.col_f));
      const float og = sigmoid_acc(pick(z, a.col_o));
      const float gg = tanhf(pick(z, a.col_g));
      const float c_new = __fadd_rn(__fmul_rn(fg, creg[i]), __fmul_rn(ig, gg));
      float h_car = rt<T>(og * tanhf(c_new)), c_car = rt<T>(c_new), y = h_car;
      const long long at = (long long)(b_base + bl) * TH + (long long)t * H + j0 + j;
      if (a.mask != nullptr) {
        y = rt<T>(__fmul_rn(mv[i], h_car));
        h_car = blend<T>(mv[i], h_car, hreg[i]);
        c_car = blend<T>(mv[i], c_car, creg[i]);
        static_cast<T*>(a.hseq)[at] = from_f<T>(h_car);
      }
      static_cast<T*>(a.y)[at] = from_f<T>(y);
      static_cast<T*>(a.cseq)[at] = from_f<T>(c_car);
      hreg[i] = h_car;
      creg[i] = c_car;
      if (t + 1 == steps) {
        const long long fin = (long long)(b_base + bl) * H + j0 + j;
        static_cast<T*>(a.h_fin)[fin] = from_f<T>(h_car);
        static_cast<T*>(a.c_fin)[fin] = from_f<T>(c_car);
      }
      *reinterpret_cast<T*>(hl_p + j * HROW + (hsw<W>(j, bl * ES / 16) << 4) + (bl * ES) % 16) =
          from_f<T>(h_car);
    }
    if (t + 1 == steps) break;
    __syncthreads();
    // h_t's slice (rows j0..j0+J of the next buffer) into every block of the cluster
    const int chunks = J * HROW / 16;
    const uint32_t dst = hb + (cur ^ 1) * H * HROW + j0 * HROW;
    for (int e = tid; e < chunks * CLUSTER; e += SEQ_THREADS) {
      const int peer = e / chunks, c = e % chunks;
      st_cluster16(map_rank(dst + c * 16, peer), reinterpret_cast<const uint4*>(hl_p)[c]);
    }
    cluster_barrier();
  }
  cluster_barrier();  // no block leaves while a peer may still write into its shared memory
}

// Per kernel instance and device: the dynamic shared-memory limit lifted to SMEM_MAX and the
// non-portable cluster size allowed, once (so no attribute call falls inside a graph capture),
// and the largest shared memory for which one cluster was found to fit.
struct Prepared {
  std::atomic<bool> attrs[MAX_DEVICES];
  std::atomic<int> fits[MAX_DEVICES];
};

template <typename T, int R, int MT>
Prepared& prepared() {
  static Prepared p{};
  return p;
}

using SeqKernel = void (*)(const SeqArgs);

cudaLaunchConfig_t launch_config(int clusters, int smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(CLUSTER * clusters), 1, 1);
  cfg.blockDim = dim3(SEQ_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the resident kernel that can be resident at once at `smem` bytes a block (0: the
// configuration cannot be scheduled on this card).
cudaError_t active_clusters(SeqKernel kernel, Prepared& p, int smem, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev < MAX_DEVICES;
  if (!cached || !p.attrs[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (cached) p.attrs[dev].store(true, std::memory_order_relaxed);
  }
  if (cached && p.fits[dev].load(std::memory_order_relaxed) >= smem) {
    *active = 1;
    return cudaSuccess;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, smem, nullptr, attr);
  e = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (e == cudaSuccess && *active > 0 && cached)
    p.fits[dev].store(smem, std::memory_order_relaxed);
  return e;
}

template <typename T, int MT>
SeqKernel by_rows(int r, Prepared** p) {
  if constexpr (ROWS >= 32) {
    if (r == 32) {
      *p = &prepared<T, 32, MT>();
      return lstm_seq_resident<T, 32, MT>;
    }
  }
  if constexpr (ROWS >= 16) {
    if (r == 16) {
      *p = &prepared<T, 16, MT>();
      return lstm_seq_resident<T, 16, MT>;
    }
  }
  *p = &prepared<T, 8, MT>();
  return lstm_seq_resident<T, 8, MT>;
}

// The resident kernel of a geometry: the rows a cluster carries and, in bf16, the m16 tiles of a
// column block (J / 16); the fp32 products have no m16 tiles, so fp32 is built once per row count.
SeqKernel resident_kernel(int dtype, int b, int h, Prepared** p) {
  const int r = rows_per_cluster(b);
  if (dtype == 0) return by_rows<float, 1>(r, p);
  return h / CLUSTER > 16 ? by_rows<__nv_bfloat16, 2>(r, p) : by_rows<__nv_bfloat16, 1>(r, p);
}

struct Plan {
  int body, rows, clusters, smem;
};

Plan plan_of(int dtype, int b, int h, int body) {
  Plan pl;
  pl.body = body < 0 ? pick_body(dtype, b, h) : body;
  pl.rows = rows_per_cluster(b);
  pl.clusters = (b + pl.rows - 1) / pl.rows;
  // only the resident body has a shared-memory plan: below H = CLUSTER units J is 0, and
  // k_slices would divide by it
  pl.smem = pl.body == BODY_RESIDENT ? (int)resident_smem(dtype == 0 ? 4 : 2, h, pl.rows) : 0;
  return pl;
}

bool valid(int dtype, int b, int h, int steps, int body, const SeqArgs* a) {
  bool ok = (dtype == 0 || dtype == 1) && b >= 1 && h >= 1 && steps >= 1 && body >= -1 &&
            body <= 1;
  if (a != nullptr) {
    const int seen = (1 << a->col_i) | (1 << a->col_f) | (1 << a->col_o) | (1 << a->col_g);
    ok = ok && a->col_i >= 0 && a->col_i <= 3 && a->col_f >= 0 && a->col_f <= 3 &&
         a->col_o >= 0 && a->col_o <= 3 && a->col_g >= 0 && a->col_g <= 3 && seen == 0xF &&
         a->xp_sb >= 1 && a->xp_st >= 1;
  }
  // a forced resident body still needs the geometry the kernel is written for
  if (ok && body == BODY_RESIDENT) {
    ok = h % (CLUSTER * 16) == 0 && h / CLUSTER <= MAX_UNITS &&
         resident_smem(dtype == 0 ? 4 : 2, h, rows_per_cluster(b)) <= SMEM_MAX;
  }
  return ok;
}

int launch_step_body(const SeqArgs& a, int dtype, cudaStream_t s) {
  const int es = dtype == 0 ? 4 : 2;
  const long long TH = (long long)a.steps * a.h;
  const bool masked = a.mask != nullptr;
  auto at = [es](const void* p, long long elems) {
    return static_cast<const char*>(p) + elems * es;
  };
  for (int t = 0; t < a.steps; ++t) {
    StepArgs st{};
    st.xp = at(a.xp, (long long)t * a.xp_st);
    st.xp_stride = a.xp_sb;
    const void* h_car = masked ? a.hseq : a.y;
    st.h_prev = t == 0 ? a.h0 : at(h_car, (long long)(t - 1) * a.h);
    st.h_stride = t == 0 ? a.h : TH;
    st.c_prev = t == 0 ? a.c0 : at(a.cseq, (long long)(t - 1) * a.h);
    st.c_stride = t == 0 ? a.h : TH;
    st.u = a.u;
    st.mask = masked ? at(a.mask, t) : nullptr;
    st.m_stride = a.steps;
    st.y = const_cast<char*>(at(a.y, (long long)t * a.h));
    st.c_out = const_cast<char*>(at(a.cseq, (long long)t * a.h));
    st.hc_out = masked ? const_cast<char*>(at(a.hseq, (long long)t * a.h)) : nullptr;
    st.y_stride = st.c_out_stride = st.hc_stride = TH;
    st.b = a.b;
    st.h = a.h;
    st.col_i = a.col_i; st.col_f = a.col_f; st.col_o = a.col_o; st.col_g = a.col_g;
    const int rc = dl4j_lstm_step_launch(&st, dtype, s);
    if (rc != 0) return rc;
  }
  const size_t row = (size_t)a.h * es, pitch = (size_t)TH * es;
  const long long last = (long long)(a.steps - 1) * a.h;
  cudaError_t e = cudaMemcpy2DAsync(a.h_fin, row, at(masked ? a.hseq : a.y, last), pitch, row,
                                    (size_t)a.b, cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpy2DAsync(a.c_fin, row, at(a.cseq, last), pitch, row, (size_t)a.b,
                          cudaMemcpyDeviceToDevice, s);
  return (int)e;
}

}  // namespace

extern "C" {

// The plan of one launch of dl4j_lstm_seq_fwd: the body (0 step, 1 resident; `body` -1 lets
// pick_body choose, 0 or 1 forces it), the rows a cluster carries, the clusters, the shared memory
// of a resident block and, for the resident body, how many of its clusters the card can hold at
// once (0: it cannot be scheduled here). Returns a cudaError_t.
int dl4j_lstm_seq_plan(int dtype, int b, int h, int body, int* out_body, int* rows,
                       int* clusters, int* smem, int* active) {
  if (!valid(dtype, b, h, 1, body, nullptr)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(dtype, b, h, body);
  *out_body = pl.body;
  *rows = pl.rows;
  *clusters = pl.clusters;
  *smem = pl.smem;
  *active = 0;
  if (pl.body != BODY_RESIDENT) return 0;
  Prepared* p = nullptr;
  const SeqKernel k = resident_kernel(dtype, b, h, &p);
  return (int)active_clusters(k, *p, pl.smem, active);
}

// T = steps LSTM steps in one call. dtype: 0 = float32, 1 = bfloat16 (every tensor of one type).
// xp (B, T, 4H) at row stride xp_sb and step stride xp_st (elements; each row's 4H contiguous);
// h0, c0 (B, H), U (H, 4H), mask (B, T) or null, y, cseq and (with a mask) hseq (B, T, H), h_fin
// and c_fin (B, H), all contiguous. col_*: the z column block of each gate. body: -1 pick_body's,
// 0 the step body, 1 the resident body (which must fit). Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (cudaErrorInvalidConfiguration where no
// cluster of the resident body can be resident on this card).
int dl4j_lstm_seq_fwd(const void* xp, const void* h0, const void* c0, const void* u,
                      const void* mask, void* y, void* hseq, void* cseq, void* h_fin, void* c_fin,
                      int dtype, int b, int hidden, int steps, long long xp_sb, long long xp_st,
                      int col_i, int col_f, int col_o, int col_g, int body, void* stream) {
  SeqArgs a;
  a.xp = xp; a.h0 = h0; a.c0 = c0; a.u = u; a.mask = mask;
  a.y = y; a.hseq = hseq; a.cseq = cseq; a.h_fin = h_fin; a.c_fin = c_fin;
  a.b = b; a.h = hidden; a.steps = steps; a.xp_sb = xp_sb; a.xp_st = xp_st;
  a.col_i = col_i; a.col_f = col_f; a.col_o = col_o; a.col_g = col_g;
  if (!valid(dtype, b, hidden, steps, body, &a) || (mask != nullptr && hseq == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan_of(dtype, b, hidden, body);
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (pl.body == BODY_STEP) return launch_step_body(a, dtype, s);
  Prepared* p = nullptr;
  const SeqKernel k = resident_kernel(dtype, b, hidden, &p);
  int active = 0;
  cudaError_t e = active_clusters(k, *p, pl.smem, &active);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(pl.clusters, pl.smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
