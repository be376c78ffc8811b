// K3: paged decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/paged_attention.py
// _paged_kernel (reached from paged_decode_attention). Same function: one
// query per decode slot, scaled and rotated by the caller, attends over the
// slot's first length[s] tokens (length clamped to [0, capacity]); token t of
// slot s lives at pool row (page_table[s, t / page], t % page); the caller's
// optional (S, capacity) bool mask adds the finite MASK_VALUE to the tokens it
// marks; the softmax runs online in f32. A slot with length 0 gets the
// uniform average of its capacity's values, as in the JAX kernel, where
// every token past the length scores the finite MASK_VALUE. Two builds
// behind one C interface with a dtype code (0 f32, 1 bf16): q, the pools and
// the output all f32 or all bf16 (the engine's cache_dtype); scores, the
// softmax, the value sums and the merge's scratch are f32 in both, and the
// bf16 build rounds only its output. A bf16 page is half an f32 one's bytes,
// so the plan fits twice the rows in a stage's bytes; a consumer lane reads
// its channels lane + 32k as 2-byte elements (two lanes share a 4-byte
// shared-memory word, which the bank broadcasts), and the producer copies
// rows that are no multiple of 16 bytes element by element.
//
// What bounds it: decode reads every valid K/V row once and does two FMAs per
// element read, so it is bound by memory bytes (at the flagship serve's CA,
// 112 MB: 0.034 ms at 3.35 TB/s). What held the first design (a grid of
// (slot, head, split) CTAs, each reading its head's 256-byte pieces of a run
// of the slot's pages row by row) at 16% of the card's rate, and what this
// one does about each:
//
// 1. The split was per slot, so a length-1 slot held as many CTAs as a
//    16320-token one, and the long slot's CTAs each streamed half a MB
//    alone. Now one fixed grid (one or two CTAs an SM) walks the pages of
//    every slot as one list: each CTA forms P_tot = sum_s ceil(len_s / page)
//    from the lengths on the device and takes the run of chunk =
//    ceil(P_tot / grid) consecutive pages that starts at its index times
//    chunk. Where a run crosses from one slot into the next, it is two work
//    items; an item never crosses a slot, so there are at most grid + S of
//    them, and every CTA streams at most chunk pages. Item (virtual slot v,
//    CTA b) writes its partial (max, sum, acc[Dv]) per head to scratch row
//    v + b, unique because a slot's items have consecutive b and the next
//    slot starts at the b its predecessor ended on or later. Nothing is
//    read back to the host (ops/paged_attention.py::paged_work_items is the
//    same rule in Python, for the tests).
// 2. Too few bytes were in flight, behind a dependent table load per row.
//    Now one producer warp reads 32 of an item's page-table entries at once,
//    up front, and copies whole pages (or, where a page does not fit three
//    stages, runs of its rows) into a ring of shared-memory stages ahead of
//    use: one cp.async.bulk (the Tensor Memory Accelerator's 1-D copy) each
//    for the K and the V rows, completing on the stage's mbarrier, where the
//    bytes and offsets are multiples of 16, and 4-byte cp.async by the
//    producer's lanes otherwise (chosen from the geometry and the pools'
//    alignment before launch). At the flagship a stage is one 16-row page of
//    K and of V, 64 KB, and three are in flight.
// 3. One head a CTA read a page as 8 strided pieces from 8 CTAs. A page of
//    the pool is contiguous across heads, so a stage holds all heads of its
//    rows (or a group of heads, where even one row of all heads does not
//    fit three stages: the virtual slots of item 1 are then (head group,
//    slot) pairs) and consumer warps (up to 8) own heads. A consumer warp
//    scores 16 tokens of a head at once, lanes across channels, with no
//    branch on the tile's edge (rows past it read its last row and get
//    probability 0): each lane's 16 partial dot products are summed across
//    the warp by one butterfly that halves the values it carries at each
//    step (16 shuffles for 16 tokens, where reducing each token alone takes
//    80), which leaves token u's score in lanes 2u and 2u + 1; one exp a
//    lane, then 16 shuffles broadcast the probabilities to the lanes' value
//    columns.
// 4. The mask was turned into an f32 bias by an extra device op each call,
//    and pass 2 was a launch of its own too. Now the producer reads the
//    caller's bool mask (1 byte a token, with a row stride) into the stage
//    beside the rows, and a call is two launches and nothing else: the walk,
//    then the merge of each (slot, head)'s partials in a fixed order,
//    launched as the walk's programmatic dependent (its CTAs start while
//    the walk runs and wait on griddepcontrol for its partials), 4 items in
//    flight a warp.
//
// On the H100, fewer rows a stage (more, smaller stages) and two CTAs an SM
// were slower at the serve's CA case.
//
// Head dims up to 512 (the heads-major K8's limit, so the paged and the
// cache-free routes serve the same heads; JAX's kernel takes any width whose
// packed row is a multiple of 128 lanes). A lane carries CPL = 1, 2, 4, 8 or
// 16 channels of a head (lane + 32k), so the butterfly and the probability
// broadcast are those of the narrow heads, unchanged. Where a lane carries 8
// or 16 channels (heads over 128 wide), a consumer warp owns one head, since
// its query and accumulator then take 16 or 32 of a lane's registers, and a
// head group holds at most 8 heads; the plan sizes a stage's rows by the
// wider rows' bytes, down to one row of a group where a page of it does not
// fit three stages. The merge carries MC = 16 channels a lane for such heads
// (4 otherwise) and loads two items a warp at once instead of four.
//
// Tokens at or past the slot's length never enter the walk's softmax. A
// masked token contributes exactly 0 once its slot has an unmasked one. A
// slot whose every valid token is masked has, with the finite MASK_VALUE,
// every score equal, and the plain version (and the JAX kernel, which walks
// every page of a slot) then averages the slot's whole capacity, since there
// a token past the length takes MASK_VALUE too: the merge adds that slot's
// tokens from its length to its capacity at MASK_VALUE's weight, a walk
// that only such a slot pays. A slot with length 0 has no item; its merge
// CTAs average the whole capacity the same way, with weight 1, before they
// wait for the walk, so that work overlaps it. That walk sums a page's rows
// once for a run of equal page-table entries: a retired slot's row points
// at the scratch page throughout, so it reads one page, not 16384 tokens
// (0.295 ms at the serve's CA token by token; PERF.md). Two slots may name the same pool page
// (shared prefix grants): a page is only ever read.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_CW = 8;                    // consumer warps a CTA, at most
constexpr int MAX_D = 512;                   // head dims, at most (16 channels a lane)
constexpr int NT = (MAX_CW + 1) * 32;        // threads a CTA, at most (warp 0 produces)
constexpr int TB = 16;                       // tokens a consumer warp scores at once
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 8;
constexpr int MERGE_THREADS = 256;
constexpr int HEADER = 2 * MAX_STAGES * 8;   // the stages' full and empty mbarriers
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // ops/flash_attention.py MASK_VALUE
constexpr unsigned FULL = 0xffffffffu;

// T: the element type of q, the pools and the output (float or bf16)
template <typename T>
struct Params {
  const T* q;           // (S, H * Dqk)
  const T* kpool;       // (P, page, H * Dqk)
  const T* vpool;       // (P, page, H * Dv)
  const int* table;     // (S, pps)
  const int* length;    // (S,)
  const unsigned char* mask;  // (S, >= capacity) bool with row stride mask_stride, or null
  long long mask_stride;
  float* part;          // (S * groups + grid, gh, Dv + 2) scratch
  T* out;               // (S, H * Dv)
  int slots, h, dqk, dv, page, pps;
  int grid, groups, gh, rows, stages, ncw, bulk;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// n elements of T rounded up to a whole number of 16-byte chunks
template <typename T>
__host__ __device__ inline int round16(int n) {
  constexpr int E = 16 / sizeof(T);
  return (n + E - 1) / E * E;
}

// bytes of one stage: K rows, V rows (T), the rows' mask bias (f32), each
// 16-byte aligned
template <typename T>
__host__ __device__ inline int stage_bytes(int rows, int gh, int dqk, int dv) {
  return (int)sizeof(T) * (round16<T>(rows * gh * dqk) + round16<T>(rows * gh * dv)) + 4 * round4(rows);
}

// bytes before the stages: the mbarriers, then each slot's first page in the
// walk and its clamped length (S + 1 and S ints), rounded to 128
__host__ __device__ inline int header_bytes(int slots) { return HEADER + (((2 * slots + 1) * 4 + 127) & ~127); }

template <typename T>
__host__ __device__ inline int smem_bytes(const Params<T>& p) {
  return header_bytes(p.slots) + p.stages * stage_bytes<T>(p.rows, p.gh, p.dqk, p.dv);
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sptr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(sptr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(sptr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(sptr(bar)), "r"(parity)
        : "memory");
  }
}

// the executing thread's earlier cp.asyncs arrive on `bar` when they land
// (the pending count is raised now, so the barrier's count is unchanged)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(sptr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sptr(dst)), "l"(src) : "memory");
}

// one 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   sptr(dst)),
               "l"(src), "r"(bytes), "r"(sptr(bar))
               : "memory");
}

template <typename T>
__device__ __forceinline__ int slot_pages(const Params<T>& p, int s, int* len_out) {
  int len = p.length[s];
  len = len < 0 ? 0 : len > p.pps * p.page ? p.pps * p.page : len;
  *len_out = len;
  return (len + p.page - 1) / p.page;
}

// The partition: the walk's first page of each slot (off[s], off[S] = P1, the
// pages of all slots) and each slot's clamped length, by warp 0 in chunks of
// 32 slots. Virtual slot v = g * S + s (head group g) starts at
// g * P1 + off[s].
template <typename T>
__device__ void partition(const Params<T>& p, int* off, int* len) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int s0 = 0; s0 < p.slots; s0 += 32) {
    const int s = s0 + lane;
    int l = 0, n = 0;
    if (s < p.slots) n = slot_pages(p, s, &l);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += x;
    }
    if (s < p.slots) {
      off[s] = carry + incl - n;
      len[s] = l;
    }
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) off[p.slots] = carry;
}

struct Walk {
  const int* off;
  int slots, p1;
  __device__ int voff(int v) const { return (v / slots) * p1 + off[v % slots]; }
};

// The walk of one role over this CTA's work items and their tiles; `item`
// is called once per item with (virtual slot, first page, end page), the
// role's tile loop inside it.
template <typename T, typename ItemFn>
__device__ __forceinline__ void for_items(const Params<T>& p, const int* off, ItemFn item) {
  const Walk w{off, p.slots, off[p.slots]};
  const int total = p.groups * w.p1;
  const int chunk = (total + p.grid - 1) / p.grid;
  if (total == 0) return;
  const int v_begin = blockIdx.x * chunk;
  const int v_end = min(total, v_begin + chunk);
  int sv = 0;
  for (int v = v_begin; v < v_end;) {
    while (w.voff(sv + 1) <= v) ++sv;
    const int base = w.voff(sv);
    const int pe = min(v_end, w.voff(sv + 1)) - base;
    item(sv, v - base, pe);
    v = base + pe;
  }
}

// the producer warp: page-table entries 32 at a time, each tile's rows into
// the next free stage, the tile's mask bias beside them
template <typename T>
__device__ void produce(const Params<T>& p, const int* off, const int* len, unsigned char* tiles, uint64_t* full,
                        uint64_t* empty) {
  constexpr uint32_t ES = sizeof(T);
  const int lane = threadIdx.x & 31;
  const int gwk = p.gh * p.dqk, gwv = p.gh * p.dv;
  const int kst = round16<T>(p.rows * gwk), vst = round16<T>(p.rows * gwv);
  const int sb = stage_bytes<T>(p.rows, p.gh, p.dqk, p.dv);
  const long ck = (long)p.h * p.dqk, cv = (long)p.h * p.dv;
  int st = 0, ph = 0;
  for_items(p, off, [&](int sv, int pb, int pe) {
    const int s = sv % p.slots, g = sv / p.slots;
    const int n_tok = len[s];
    const int ghc = min(p.gh, p.h - g * p.gh);
    const int kw = ghc * p.dqk, vw = ghc * p.dv;  // elements a row of the group
    const T* kbase = p.kpool + (long)g * gwk;
    const T* vbase = p.vpool + (long)g * gwv;
    const int* trow = p.table + (long)s * p.pps;
    const unsigned char* mrow = p.mask == nullptr ? nullptr : p.mask + s * p.mask_stride;
    for (int j0 = pb; j0 < pe; j0 += 32) {
      const int mine = j0 + lane < pe ? trow[j0 + lane] : 0;
      const int nj = min(32, pe - j0);
      for (int jj = 0; jj < nj; ++jj) {
        const long pid = __shfl_sync(FULL, mine, jj);
        const int tp = (j0 + jj) * p.page;
        for (int r0 = 0; r0 < p.page && tp + r0 < n_tok; r0 += p.rows) {
          const int nr = min(p.rows, min(p.page - r0, n_tok - tp - r0));
          const long row0 = pid * p.page + r0;
          T* ks = reinterpret_cast<T*>(tiles + (long)st * sb);
          T* vs = ks + kst;
          float* bs = reinterpret_cast<float*>(vs + vst);
          mbar_wait(&empty[st], ph ^ 1);
          if (p.bulk) {
            if (lane == 0) mbar_arrive_expect_tx(&full[st], ES * nr * (kw + vw));
            __syncwarp();
            if (p.groups == 1) {
              if (lane == 0) {
                bulk_copy(ks, kbase + row0 * ck, ES * nr * kw, &full[st]);
                bulk_copy(vs, vbase + row0 * cv, ES * nr * vw, &full[st]);
              }
            } else {
              for (int r = lane; r < nr; r += 32) {
                bulk_copy(ks + r * gwk, kbase + (row0 + r) * ck, ES * kw, &full[st]);
                bulk_copy(vs + r * gwv, vbase + (row0 + r) * cv, ES * vw, &full[st]);
              }
            }
          } else if constexpr (sizeof(T) == 4) {
            for (int e = lane; e < nr * kw; e += 32) {
              const int r = e / kw, c = e - r * kw;
              cp_async4(ks + r * gwk + c, kbase + (row0 + r) * ck + c);
            }
            for (int e = lane; e < nr * vw; e += 32) {
              const int r = e / vw, c = e - r * vw;
              cp_async4(vs + r * gwv + c, vbase + (row0 + r) * cv + c);
            }
            cp_async_arrive(&full[st]);
          } else {
            // 2-byte elements: no cp.async that small; plain copies, which
            // each lane's arrival below releases to the consumers
            for (int e = lane; e < nr * kw; e += 32) {
              const int r = e / kw, c = e - r * kw;
              ks[r * gwk + c] = kbase[(row0 + r) * ck + c];
            }
            for (int e = lane; e < nr * vw; e += 32) {
              const int r = e / vw, c = e - r * vw;
              vs[r * gwv + c] = vbase[(row0 + r) * cv + c];
            }
          }
          // lane 0's arrival (with the expected bytes) may precede its
          // copies, so the bias is written by the other lanes, each before
          // its own arrival
          if (lane > 0) {
            for (int r = lane - 1; r < nr; r += 31)
              bs[r] = (mrow != nullptr && mrow[tp + r0 + r]) ? MASK_VALUE : 0.f;
            mbar_arrive(&full[st]);
          } else if (!p.bulk) {
            mbar_arrive(&full[st]);
          }
          if (++st == p.stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  });
}

// one step of the butterfly over a warp's TB partial scores: at offset O,
// with N values left, each lane keeps the half that its side of O owns and
// adds its partner's; after O = 16, 8, 4, 2 lane l holds token l / 2's sum
// over 16 lanes
template <int O, int N>
__device__ __forceinline__ void fold(float (&x)[TB], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int u = 0; u < N / 2; ++u) {
    const float send = upper ? x[u] : x[u + N / 2];
    const float keep = upper ? x[u + N / 2] : x[u];
    x[u] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// a consumer warp: HPW heads of each item's group (heads cw, cw + ncw, ...),
// CPL channels a lane (Dqk, Dv <= 32 * CPL), f32 arithmetic on either T
template <typename T, int CPL, int HPW>
__device__ void consume(const Params<T>& p, const int* off, const int* len, const unsigned char* tiles,
                        uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31, cw = (threadIdx.x >> 5) - 1;
  const int gwk = p.gh * p.dqk, gwv = p.gh * p.dv;
  const int kst = round16<T>(p.rows * gwk), vst = round16<T>(p.rows * gwv);
  const int sb = stage_bytes<T>(p.rows, p.gh, p.dqk, p.dv);
  const int u_mine = lane >> 1;  // the token whose score this lane holds after the butterfly
  bool kc[CPL], vc[CPL];  // the lane's channels that exist
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    kc[k] = lane + 32 * k < p.dqk;
    vc[k] = lane + 32 * k < p.dv;
  }
  int st = 0, ph = 0;
  for_items(p, off, [&](int sv, int pb, int pe) {
    const int s = sv % p.slots, g = sv / p.slots;
    const int n_tok = len[s];
    const int ghc = min(p.gh, p.h - g * p.gh);
    float q[HPW][CPL], acc[HPW][CPL], m[HPW], l[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int head = cw + i * p.ncw;
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        acc[i][k] = 0.f;
        q[i][k] = head < ghc && c < p.dqk
                      ? pio::to_f32(p.q[(long)s * p.h * p.dqk + (long)(g * p.gh + head) * p.dqk + c])
                      : 0.f;
      }
    }
    for (int j = pb; j < pe; ++j) {
      const int tp = j * p.page;
      for (int r0 = 0; r0 < p.page && tp + r0 < n_tok; r0 += p.rows) {
        const int nr = min(p.rows, min(p.page - r0, n_tok - tp - r0));
        const T* ks = reinterpret_cast<const T*>(tiles + (long)st * sb);
        const T* vs = ks + kst;
        const float* bs = reinterpret_cast<const float*>(vs + vst);
        mbar_wait(&full[st], ph);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const int head = cw + i * p.ncw;
          if (head >= ghc) continue;
          const T* kh = ks + head * p.dqk;  // the sub-block's first row
          const T* vh = vs + head * p.dv;
          for (int rb = 0; rb < nr; rb += TB) {
            // rows past the tile read its last row (no branch): their
            // scores are dropped and their probabilities are 0
            const int last = nr - 1 - rb;
            float x[TB];
#pragma unroll
            for (int u = 0; u < TB; ++u) {
              const T* kr = kh + min(u, last) * gwk;
              x[u] = 0.f;
#pragma unroll
              for (int k = 0; k < CPL; ++k)
                if (kc[k]) x[u] = fmaf(q[i][k], pio::to_f32(kr[lane + 32 * k]), x[u]);
            }
            fold<16, 16>(x, lane);
            fold<8, 8>(x, lane);
            fold<4, 4>(x, lane);
            fold<2, 2>(x, lane);
            x[0] += __shfl_xor_sync(FULL, x[0], 1);
            const bool valid = u_mine <= last;
            const float sc = valid ? x[0] + bs[rb + min(u_mine, last)] : -CUDART_INF_F;
            float mt = sc;
#pragma unroll
            for (int o = 2; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
            // row rb is valid, so mt and m_new are finite
            const float m_new = fmaxf(m[i], mt);
            const float alpha = expf(m[i] - m_new);
            const float pu = valid ? expf(sc - m_new) : 0.f;
            l[i] = fmaf(l[i], alpha, pu);
#pragma unroll
            for (int k = 0; k < CPL; ++k) acc[i][k] *= alpha;
#pragma unroll
            for (int u = 0; u < TB; ++u) {
              const float pv = __shfl_sync(FULL, pu, 2 * u);
              const T* vr = vh + min(u, last) * gwv;
#pragma unroll
              for (int k = 0; k < CPL; ++k)
                if (vc[k]) acc[i][k] = fmaf(pv, pio::to_f32(vr[lane + 32 * k]), acc[i][k]);
            }
            kh += TB * gwk;
            vh += TB * gwv;
            m[i] = m_new;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    // the item's partial: lanes 2u and 2u + 1 summed the same probabilities
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int head = cw + i * p.ncw;
      float li = l[i];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) li += __shfl_xor_sync(FULL, li, o);
      if (head >= ghc) continue;
      float* dst = p.part + ((long)(sv + blockIdx.x) * p.gh + head) * (p.dv + 2);
      if (lane == 0) {
        dst[0] = m[i];
        dst[1] = li;
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < p.dv) dst[2 + c] = acc[i][k];
      }
    }
  });
}

template <typename T, int CPL, int HPW>
__global__ void __launch_bounds__(NT, 1) paged_walk_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  int* off = reinterpret_cast<int*>(smem + HEADER);
  int* len = off + p.slots + 1;
  unsigned char* tiles = smem + header_bytes(p.slots);
  // the merge may launch now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    partition(p, off, len);
    if (threadIdx.x == 0) {
      for (int i = 0; i < p.stages; ++i) {
        mbar_init(&full[i], 32);
        mbar_init(&empty[i], p.ncw);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if (warp == 0)
    produce(p, off, len, tiles, full, empty);
  else
    consume<T, CPL, HPW>(p, off, len, tiles, full, empty);
}

// one (slot, head): the slot's items' partials merged, warp w taking items
// w, w + 8, ... with a running max, then the 8 warps joined in order (a
// fixed order: the result does not depend on timing). Launched as the walk's
// programmatic dependent: its CTAs start while the walk runs, form the
// slot's geometry from the lengths, then wait for the walk's partials.
template <typename T, int MC>
__global__ void __launch_bounds__(MERGE_THREADS) paged_merge_kernel(const Params<T> p) {
  constexpr int NW = MERGE_THREADS / 32;
  __shared__ float sm_m[NW], sm_l[NW], sm_acc[NW][32 * MC], sm_tail[NW][32 * MC];
  __shared__ int geo[4];
  const int s = blockIdx.x, hd = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int before = 0, total = 0, mine = 0, mine_len = 0;
    for (int j = lane; j < p.slots; j += 32) {
      int l;
      const int n = slot_pages(p, j, &l);
      total += n;
      before += j < s ? n : 0;
      mine += j == s ? n : 0;
      mine_len += j == s ? l : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_xor_sync(FULL, total, o);
      before += __shfl_xor_sync(FULL, before, o);
      mine += __shfl_xor_sync(FULL, mine, o);
      mine_len += __shfl_xor_sync(FULL, mine_len, o);
    }
    if (lane == 0) {
      geo[0] = total;
      geo[1] = before;
      geo[2] = mine;
      geo[3] = mine_len;
    }
  }
  __syncthreads();
  const int p1 = geo[0], n = geo[2], len = geo[3];
  T* o = p.out + (long)s * p.h * p.dv + (long)hd * p.dv;
  constexpr int IF = MC <= 4 ? 4 : 2;  // items a warp loads at once
  float m = -CUDART_INF_F, l = 0.f, acc[MC];
#pragma unroll
  for (int k = 0; k < MC; ++k) acc[k] = 0.f;
  if (n > 0) {  // a slot of length 0 has no item
    const int g = hd / p.gh, hh = hd - g * p.gh;
    const int chunk = (p.groups * p1 + p.grid - 1) / p.grid;
    const int voff = g * p1 + geo[1];
    const int b0 = voff / chunk, nb = (voff + n - 1) / chunk - b0 + 1;
    const long stride = (long)p.gh * (p.dv + 2);
    const float* base = p.part + ((long)(g * p.slots + s + b0) * p.gh + hh) * (p.dv + 2);
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the walk's partials are written
    for (int b = warp; b < nb; b += NW * IF) {
      float mb[IF], lb[IF], ab[IF][MC];
#pragma unroll
      for (int j = 0; j < IF; ++j) {
        const bool ok = b + j * NW < nb;
        const float* it = base + (ok ? b + j * NW : b) * stride;
        mb[j] = ok ? it[0] : -CUDART_INF_F;
        lb[j] = it[1];
#pragma unroll
        for (int k = 0; k < MC; ++k) ab[j][k] = lane + 32 * k < p.dv ? it[2 + lane + 32 * k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < IF; ++j) {
        if (mb[j] == -CUDART_INF_F) continue;
        const float m_new = fmaxf(m, mb[j]);
        const float alpha = expf(m - m_new), wb = expf(mb[j] - m_new);
        l = fmaf(l, alpha, wb * lb[j]);
#pragma unroll
        for (int k = 0; k < MC; ++k) acc[k] = fmaf(acc[k], alpha, wb * ab[j][k]);
        m = m_new;
      }
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < MC; ++k) sm_acc[warp][lane + 32 * k] = acc[k];
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
  float scale[NW], ls = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    scale[w] = sm_m[w] == -CUDART_INF_F ? 0.f : expf(sm_m[w] - mx);  // a warp with no item
    ls = fmaf(sm_l[w], scale[w], ls);
  }
  // every valid token masked (an unmasked score is far above MASK_VALUE / 2),
  // or none (length 0): every token of the capacity scores MASK_VALUE, so
  // the tokens from the length to the capacity join at MASK_VALUE's weight
  // (weight 1 where there is no valid token). The rest of the length's page,
  // token by token over the warps, then the whole pages after it: warp w
  // takes a contiguous share of the page-table entries and sums a page's
  // rows once for a run of equal entries (a retired slot's row is all
  // scratch page), adding the run's count times that sum. A fixed order for
  // every CTA.
  const int cap = p.pps * p.page;
  const bool tail = (n == 0 || mx < 0.5f * MASK_VALUE) && len < cap;
  const float w_tail = n == 0 ? 1.f : tail ? expf(MASK_VALUE - mx) : 0.f;
  if (tail) {
    const long row = (long)p.h * p.dv;
    const T* vcol = p.vpool + (long)hd * p.dv;
    const int* trow = p.table + (long)s * p.pps;
    float t_acc[MC], run[MC];
#pragma unroll
    for (int k = 0; k < MC; ++k) t_acc[k] = run[k] = 0.f;
    const int j_first = (len + p.page - 1) / p.page;
    for (int t = len + warp; t < j_first * p.page; t += NW) {
      const T* vr = vcol + ((long)trow[t / p.page] * p.page + t % p.page) * row;
#pragma unroll
      for (int k = 0; k < MC; ++k)
        if (lane + 32 * k < p.dv) t_acc[k] += pio::to_f32(vr[lane + 32 * k]);
    }
    const int per = (p.pps - j_first + NW - 1) / NW;
    const int ja = j_first + warp * per, jb = min(p.pps, ja + per);
    int prev = -1, count = 0;
    for (int j0 = ja; j0 < jb; j0 += 32) {
      const int mine = j0 + lane < jb ? trow[j0 + lane] : -1;
      const int nj = min(32, jb - j0);
      for (int i = 0; i < nj; ++i) {
        const int e = __shfl_sync(FULL, mine, i);
        if (e == prev) {
          ++count;
          continue;
        }
#pragma unroll
        for (int k = 0; k < MC; ++k) t_acc[k] = fmaf((float)count, run[k], t_acc[k]);
        const T* vp = vcol + (long)e * p.page * row;
#pragma unroll
        for (int k = 0; k < MC; ++k) run[k] = 0.f;
#pragma unroll 4
        for (int r = 0; r < p.page; ++r)
#pragma unroll
          for (int k = 0; k < MC; ++k)
            if (lane + 32 * k < p.dv) run[k] += pio::to_f32(vp[r * row + lane + 32 * k]);
        prev = e;
        count = 1;
      }
    }
#pragma unroll
    for (int k = 0; k < MC; ++k) sm_tail[warp][lane + 32 * k] = fmaf((float)count, run[k], t_acc[k]);
    __syncthreads();
    ls = fmaf(w_tail, (float)(cap - len), ls);
  }
  // a slot with no item overlapped the walk; the merge still ends after it
  if (n == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int c = threadIdx.x; c < p.dv; c += MERGE_THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a = fmaf(sm_acc[w][c], scale[w], a);
    if (tail) {
      float t_sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) t_sum += sm_tail[w][c];
      a = fmaf(w_tail, t_sum, a);
    }
    o[c] = pio::from_f32<T>(a / ls);
  }
}

template <typename T>
using KernelFn = void (*)(Params<T>);

// the walk's instantiation: CPL channels a lane (1, 2, 4, and 8, 16 for
// heads wider than 128), HPW heads a consumer warp (1, 2, 4; 1 for the wide
// heads, whose query and accumulator fill a lane's registers alone)
template <typename T>
KernelFn<T> walk_kernel(int cpl, int hpw) {
  static const KernelFn<T> table[3][3] = {
      {paged_walk_kernel<T, 1, 1>, paged_walk_kernel<T, 1, 2>, paged_walk_kernel<T, 1, 4>},
      {paged_walk_kernel<T, 2, 1>, paged_walk_kernel<T, 2, 2>, paged_walk_kernel<T, 2, 4>},
      {paged_walk_kernel<T, 4, 1>, paged_walk_kernel<T, 4, 2>, paged_walk_kernel<T, 4, 4>},
  };
  if (cpl == 8) return paged_walk_kernel<T, 8, 1>;
  if (cpl == 16) return paged_walk_kernel<T, 16, 1>;
  return table[cpl == 1 ? 0 : cpl == 2 ? 1 : 2][hpw == 1 ? 0 : hpw == 2 ? 1 : 2];
}

int cpl_of(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : d <= 256 ? 8 : 16;
}

int hpw_of(int gh) { return gh <= MAX_CW ? 1 : gh <= 2 * MAX_CW ? 2 : 4; }

// the most heads a group may hold: up to 4 a consumer warp, one where a lane
// carries 8 or 16 channels
int max_gh(int cpl) { return cpl <= 4 ? 4 * MAX_CW : MAX_CW; }

// the merge's instantiation: MC channels a lane, 4 (Dv <= 128) or 16
template <typename T>
KernelFn<T> merge_kernel(int dv) {
  return dv <= 128 ? paged_merge_kernel<T, 4> : paged_merge_kernel<T, 16>;
}

template <typename T>
cudaError_t plan_for(int slots, int h, int dqk, int dv, int page, int n_sm, int* plan) {
  int dev = 0, budget = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long head = header_bytes(slots);
  const int cpl = cpl_of(dqk, dv);
  int gh = 0, groups = 0, rows = 0;
  for (int ng = 1; ng <= h; ++ng) {
    const int g = (h + ng - 1) / ng;
    if (g > max_gh(cpl)) continue;
    int r = page;
    while (r > 0 && head + MIN_STAGES * (long)stage_bytes<T>(r, g, dqk, dv) > budget) --r;
    if (r >= 1) {
      gh = g;
      groups = (h + g - 1) / g;
      rows = r;
      break;
    }
  }
  if (rows < 1) return cudaErrorInvalidValue;
  const long tile = stage_bytes<T>(rows, gh, dqk, dv);
  long stages = (budget - head) / tile;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  const int smem = (int)(head + stages * tile);
  const int hpw = hpw_of(gh);
  const int ncw = (gh + hpw - 1) / hpw;
  KernelFn<T> kernel = walk_kernel<T>(cpl, hpw);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, (ncw + 1) * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan[0] = n_sm * (per_sm >= 2 ? 2 : 1);
  plan[1] = groups;
  plan[2] = gh;
  plan[3] = rows;
  plan[4] = (int)stages;
  plan[5] = smem;
  plan[6] = ncw;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(Params<T> p, cudaStream_t s) {
  // 1-D bulk copies want 16-byte multiples and alignment: rows of whole
  // 16-byte chunks (4 f32 or 8 bf16 channels a head), from 16-byte aligned
  // pools
  p.bulk = (p.dqk * (int)sizeof(T)) % 16 == 0 && (p.dv * (int)sizeof(T)) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p.kpool) % 16 == 0 && reinterpret_cast<uintptr_t>(p.vpool) % 16 == 0;
  walk_kernel<T>(cpl_of(p.dqk, p.dv), hpw_of(p.gh))<<<p.grid, (p.ncw + 1) * 32, smem_bytes(p), s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.slots, p.h);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge_kernel<T>(p.dv), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K3's plan for a geometry and dtype (0 f32, 1 bf16) on the current device
// (head dims up to 512):
// plan = {grid, head groups, heads a group, rows a tile, stages, dynamic
// shared memory bytes, consumer warps}. Whole pages of all heads a stage
// where three stages fit, else runs of a page's rows, else head groups; as
// many stages as fit, up to 8; one CTA an SM where a CTA takes more than half
// of one's shared memory, else two. Also lifts the walk's shared-memory limit
// to the device's. Returns a cudaError_t.
extern "C" int pio_paged_decode_plan(int slots, int h, int dqk, int dv, int page, int n_sm, int dtype, int* plan) {
  if (slots <= 0 || h <= 0 || dqk <= 0 || dv <= 0 || dqk > MAX_D || dv > MAX_D || page <= 0 || n_sm <= 0)
    return cudaErrorInvalidValue;
  if (dtype == pio::kF32) return plan_for<float>(slots, h, dqk, dv, page, n_sm, plan);
  if (dtype == pio::kBF16) return plan_for<__nv_bfloat16>(slots, h, dqk, dv, page, n_sm, plan);
  return cudaErrorInvalidValue;
}

// q (S, H*Dqk); pools k (P, page, H*Dqk), v (P, page, H*Dv); table (S, pps)
// and length (S,) int32; mask (S, >= pps*page) bool with row stride
// mask_stride, or null; part (S * groups + grid, gh, Dv + 2) f32 scratch; out
// (S, H*Dv); all contiguous; q, the pools and out all f32 (dtype 0) or all
// bf16 (dtype 1); the plan's values from pio_paged_decode_plan for this
// geometry and dtype. Launches the walk, then the merge. Returns a
// cudaError_t (0 = launched).
extern "C" int pio_paged_decode(const void* q, const void* kpool, const void* vpool, const int* table,
                                const int* length, const unsigned char* mask, long long mask_stride, float* part,
                                void* out, int slots, int h, int dqk, int dv, int page, int pps, int grid,
                                int groups, int gh, int rows, int stages, int ncw, int dtype, void* stream) {
  if (slots <= 0 || h <= 0) return cudaSuccess;
  if (dqk <= 0 || dv <= 0 || dqk > MAX_D || dv > MAX_D || page <= 0 || pps <= 0 || grid <= 0 ||
      groups <= 0 || gh <= 0 || gh > max_gh(cpl_of(dqk, dv)) || (long)gh * groups < h || rows <= 0 ||
      rows > page || stages < 1 ||
      stages > MAX_STAGES || ncw <= 0 || ncw > MAX_CW || (long)ncw * hpw_of(gh) < gh || slots > 65535 ||
      h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kF32)
    return launch(Params<float>{static_cast<const float*>(q), static_cast<const float*>(kpool),
                                static_cast<const float*>(vpool), table, length, mask, mask_stride, part,
                                static_cast<float*>(out), slots, h, dqk, dv, page, pps, grid, groups, gh, rows,
                                stages, ncw, 0},
                  s);
  if (dtype == pio::kBF16) {
    using B = __nv_bfloat16;
    return launch(Params<B>{static_cast<const B*>(q), static_cast<const B*>(kpool), static_cast<const B*>(vpool),
                            table, length, mask, mask_stride, part, static_cast<B*>(out), slots, h, dqk, dv, page,
                            pps, grid, groups, gh, rows, stages, ncw, 0},
                  s);
  }
  return cudaErrorInvalidValue;
}
