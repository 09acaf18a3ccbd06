// The split-target 1-NN shared by K1 (both bodies), K7 and K8
// (csrc/nn_select_batched.cu), by K4 and K3 (csrc/nn_select.cu) and by K5
// (both bodies, csrc/icp_moments.cu).
//
// What bounds these kernels on the H100 is instruction issue: each
// (query, target) pair costs ((dx*dx) + (dy*dy)) + (dz*dz) and a compare,
// 9 FP32 instructions that the build keeps apart (-fmad=false and _rn
// intrinsics keep d2 bit-equal to the plain versions), so the best a kernel
// can reach is half of the stated FP32 bound (which counts a fused
// multiply-add as two operations). The design spends the rest of the
// issue slots as little as it can:
//
// - The target axis is split twice. The grid is (query groups, target
//   slices, lanes); slice s holds the targets [s * slice_len, min(nt,
//   (s + 1) * slice_len)), and each of the block's W warps walks a
//   contiguous W-th of it for the block's one group of 32 x kRq queries.
//   The geometry is read from the shapes (ops/kernels.py::
//   nn_split_geometry) so that the card holds many warps. Blocks of an
//   inactive lane exit at once; they read `active` on the device (the host
//   never does).
// - Queries are tiled in registers: each lane holds kRq queries, so each
//   target, staged in shared memory as a float4, is read by one 128-bit
//   broadcast load for all of them, and the kRq distance chains are
//   independent.
// - The selection is off the hot loop. A long walk (kGrouped) takes each
//   group of 8 targets' min by fminf, one instruction a pair, then one
//   compare and two selects a group: about 9.3 instructions a pair in all
//   (the tie average: 9.5, keeping the last group whose min was <= best).
//   After the walk it reads back the 8 targets of the first group at the
//   min (global memory, all in flight at once) for the exact lowest index,
//   or, for the tie average, every group from the first to the last at the
//   min, summing the payload of each target at exactly that d2 in ascending
//   order. A short walk (below kGroupedFrom targets a warp; the lowest
//   index only) keeps the exact index per pair instead, one compare and
//   two selects (about 12 instructions a pair), since the read-back's
//   latency would cost it more than the groups save. No branch in either
//   walk: a lane full of ties costs its read-back, not its walk.
// - Tiles are staged ahead: each warp owns two shared-memory buffers that
//   cp.async fills (targets past its range read as infinitely far), the
//   next tile in flight while this one is consumed, synchronised with
//   __syncwarp only (no block barrier in the walk).
// - Partials are merged in a fixed order, with no float atomics. The warps
//   of a block merge in shared memory, in ascending warp order (their
//   ranges ascend). With one slice, that is the answer. Otherwise each block
//   writes its slice's partial per query: (min d2, tie count, payload sums)
//   for the tie average, (min d2, lowest index) for the lowest index; the
//   last block of a (query group, lane) to arrive merges them in ascending
//   slice order (an arrival counter that resets itself, atomicInc wrapping
//   at slices - 1; each entry point owns its counters, ops/kernels.py),
//   loading 8 slices' partials at a time. That end costs about 3 us on an
//   H100 (a fence, the arrival, the partials' and the winner's loads: see
//   the floor lines of scripts/torch_nn_split_sweep.py and PERF.md); a
//   second launch costs as much (its loads, and about 1 us between two
//   kernels of a graph), and a trial that merged the slices of a thread
//   block cluster through distributed shared memory was slower at K4's
//   8 slices (its code was not kept).
//   Strict < keeps the lowest index; the tie average adds a range's sums
//   and count only where its min equals the running min and its count is
//   > 0 (a range with no finite target never "ties" at inf). Ties of three
//   or more that span ranges are summed range by range: the order differs
//   from the plain version's by at most 2 ulp of the payload magnitude.
// - What differs between the kernels is three compile-time policies of one
//   walk (the kernel's `Op`): where a query comes from (NnOp: [lanes, nq,
//   3] rows; K5's MomentsOp moves a point of src4 by its lane's pose), the
//   distance (NnOp: per coordinate; K8's ExpandedOp: (qq - 2 c) + tt, with
//   tt staged in each tile target's .w), and the finish (NnOp: d and the
//   selection or index per query; MomentsOp: the 18 gated moment terms of
//   the block's queries, reduced to one row per query group, and zero
//   terms for an inactive lane). NnOp's functions are the code the kernel
//   had before the policies existed.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scl {
// Internal linkage: each source that includes this header gets its own
// kernels (the build compiles every source alone, without device linking).
namespace {

constexpr int kSplitMaxWarps = 16;  // warps of a block: one query group
constexpr int kWarpTile = 64;       // targets per warp tile (1 KB)
constexpr int kGroupLen = 8;        // targets whose min is taken before a compare
constexpr int kMergeBatch = 8;     // slices' partials loaded at once

enum class Pick {
  kTieMean,  // payload averaged over every target at exactly the min d2
  kLowest,   // the lowest index at the min d2 (then its payload, or the index)
};

// Where the targets lie: element (p, k) of lane b at
// base + b * lane + p * row + k * col (K1/K7/K4: rows of [.., P, Nt]; K3:
// the interleaved [Nt, 3]).
struct TargetView {
  const float* base;
  size_t lane, row, col;
  __device__ __forceinline__ const float* at(int b, int p, int k) const {
    return base + b * lane + p * row + static_cast<size_t>(k) * col;
  }
};

struct SplitArgs {
  const float* query;       // [lanes, nq, 3] (K5: src4 [lanes, 4, nq])
  TargetView target;
  const int32_t* active;    // [lanes], or null (every lane active)
  int nq, nt, slice_len, slices;
  float* part_d;            // [lanes, slices, nq] min d2 of each slice
  int32_t* part_i;          // [lanes, slices, nq] tie count or lowest index
  float* part_s;            // [lanes, slices, 4, nq] payload sums (kTieMean)
  uint32_t* arrivals;       // [lanes, query groups], zero between launches
  float* d_out;             // [lanes, nq]
  float* sel_out;           // [lanes, sel_rows, nq], or null
  int sel_rows;
  int32_t* idx_out;         // [lanes, nq], or null (kLowest)
  bool clamp;               // d = max(d, 0) where a target was found
};

// The result of one query over a range of targets: kTieMean keeps the
// count of targets at d and their payload sums, kLowest the lowest index.
struct Best {
  float d;
  int i;  // kTieMean: count (0: none); kLowest: index
  float s0, s1, s2, s3;
};

__device__ __forceinline__ float split_d2(float qx, float qy, float qz,
                                          float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Merges the result `p` of a later range into `m`, as one walk would.
template <Pick kPick>
__device__ __forceinline__ void merge_into(Best& m, const Best& p) {
  if constexpr (kPick == Pick::kTieMean) {
    if (p.d < m.d) {
      m = p;
    } else if (p.d == m.d && p.i > 0) {
      m.i += p.i;
      m.s0 = __fadd_rn(m.s0, p.s0);
      m.s1 = __fadd_rn(m.s1, p.s1);
      m.s2 = __fadd_rn(m.s2, p.s2);
      m.s3 = __fadd_rn(m.s3, p.s3);
    }
  } else if (p.d < m.d) {  // strict: the lower range keeps a tie
    m.d = p.d;
    m.i = p.i;
  }
}

// The outputs of query i of lane b from its merged result.
template <Pick kPick>
__device__ __forceinline__ void finish(const SplitArgs& a, int b, int i,
                                       const Best& m) {
  const size_t o = static_cast<size_t>(b) * a.nq + i;
  if constexpr (kPick == Pick::kTieMean) {
    a.d_out[o] = m.d;
    float* sel = a.sel_out + static_cast<size_t>(b) * 4 * a.nq + i;
    if (m.i > 0) {
      const float c = static_cast<float>(m.i);
      sel[0] = __fdiv_rn(m.s0, c);
      sel[a.nq] = __fdiv_rn(m.s1, c);
      sel[2 * a.nq] = __fdiv_rn(m.s2, c);
      sel[3 * a.nq] = __fdiv_rn(m.s3, c);
    } else {
      sel[0] = sel[a.nq] = sel[2 * a.nq] = sel[3 * a.nq] = 0.0f;
    }
  } else {
    const bool found = m.d < CUDART_INF_F;  // NaN distances never won
    a.d_out[o] = found && a.clamp ? fmaxf(m.d, 0.0f) : m.d;
    if (a.sel_out != nullptr) {
      for (int p = 0; p < a.sel_rows; ++p) {
        a.sel_out[(static_cast<size_t>(b) * a.sel_rows + p) * a.nq + i] =
            found ? *a.target.at(b, p, m.i) : 0.0f;
      }
    }
    if (a.idx_out != nullptr) a.idx_out[o] = found ? m.i : 0;
  }
}

// One query of the walk: its coordinates and a value of the policy's own
// (ExpandedOp: qq; MomentsOp: the source point's validity).
struct Query {
  float x, y, z, aux;
};

// The policy of K1, K7, K4 and K3: queries [lanes, nq, 3], the exact
// per-coordinate d2, targets past a range at infinity, and per query its
// d with the selection or the index (finish).
struct NnOp {
  using Args = SplitArgs;

  static __device__ __forceinline__ Query load_query(const SplitArgs& a, int b, int i) {
    const float* q = a.query + (static_cast<size_t>(b) * a.nq + i) * 3;
    return {q[0], q[1], q[2], 0.0f};
  }
  // a tile slot past the range's end: never nearest
  static __device__ __forceinline__ float4 pad() {
    return make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
  }
  // runs on the n staged targets of a warp's tile once they have landed
  static __device__ __forceinline__ void on_tile(float4*, int, int) {}
  static __device__ __forceinline__ float tile_d2(const Query& q, const float4& t) {
    return split_d2(q.x, q.y, q.z, t.x, t.y, t.z);
  }
  // the same d2 from a target's coordinates (the read-back)
  static __device__ __forceinline__ float point_d2(const Query& q, float tx, float ty,
                                                   float tz) {
    return split_d2(q.x, q.y, q.z, tx, ty, tz);
  }
  // The outputs of the block's group of queries (q0 + 32 r of lane b) from
  // their merged results, in warp 0.
  template <Pick kPick, int kRq>
  static __device__ __forceinline__ void finish_group(const SplitArgs& a, int b, int q0,
                                                      const Query*, const Best* m) {
#pragma unroll
    for (int r = 0; r < kRq; ++r) {
      if (q0 + 32 * r < a.nq) finish<kPick>(a, b, q0 + 32 * r, m[r]);
    }
  }
  // The same for a lane that is not active: no target, (inf, 0).
  template <Pick kPick, int kRq>
  static __device__ __forceinline__ void finish_inactive(const SplitArgs& a, int b, int q0) {
    Best none;
    none.d = CUDART_INF_F;
    none.i = 0;
    none.s0 = none.s1 = none.s2 = none.s3 = 0.0f;
#pragma unroll
    for (int r = 0; r < kRq; ++r) {
      if (q0 + 32 * r < a.nq) finish<kPick>(a, b, q0 + 32 * r, none);
    }
  }
};

// K8's policy: d2 by the expanded form, (qq - 2 c) + tt with qq = (qx qx +
// qy qy) + qz qz, c = (qx tx + qy ty) + qz tz and tt as qq, every step
// rounded to f32 in that order (the plain version's). tt is computed once a
// target, where its warp tile lands, into the slot's .w; a padded slot is
// at the origin with tt = inf (infinite coordinates would give inf - inf).
struct ExpandedOp : NnOp {
  static __device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                               float by, float bz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  }
  static __device__ __forceinline__ float expanded(const Query& q, float tx, float ty,
                                                   float tz, float tt) {
    return __fadd_rn(__fsub_rn(q.aux, __fmul_rn(2.0f, dot3(q.x, q.y, q.z, tx, ty, tz))), tt);
  }
  static __device__ __forceinline__ Query load_query(const SplitArgs& a, int b, int i) {
    Query q = NnOp::load_query(a, b, i);
    q.aux = dot3(q.x, q.y, q.z, q.x, q.y, q.z);
    return q;
  }
  static __device__ __forceinline__ float4 pad() {
    return make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
  }
  static __device__ __forceinline__ void on_tile(float4* tile, int n, int lane) {
    for (int k = lane; k < n; k += 32) {  // the slots this lane's copies filled
      float4& t = tile[k];
      t.w = dot3(t.x, t.y, t.z, t.x, t.y, t.z);
    }
  }
  static __device__ __forceinline__ float tile_d2(const Query& q, const float4& t) {
    return expanded(q, t.x, t.y, t.z, t.w);
  }
  static __device__ __forceinline__ float point_d2(const Query& q, float tx, float ty,
                                                   float tz) {
    return expanded(q, tx, ty, tz, dot3(tx, ty, tz, tx, ty, tz));
  }
};

template <class Op, Pick kPick, int kRq, bool kGrouped>
__global__ void __launch_bounds__(kSplitMaxWarps * 32)
nn_split_kernel(const typename Op::Args a) {
  static_assert(kGrouped || kPick == Pick::kLowest, "the tie average walks in groups");
  constexpr int kRows = 3;          // staged rows: target xyz
  constexpr int kGroup = 32 * kRq;  // queries a block
  // dynamic: each warp's two tiles during the walk, then the warps'
  // results (split_smem_bytes)
  extern __shared__ float4 smem[];
  const int b = blockIdx.z;
  const int slice = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int q0 = blockIdx.x * kGroup + lane;  // query r: q0 + 32 r

  if (a.active != nullptr && a.active[b] == 0) {  // uniform across the grid row
    if (slice == 0 && w == 0) Op::template finish_inactive<kPick, kRq>(a, b, q0);
    return;
  }

  Query q[kRq];
  float best[kRq];
  // kGrouped: the first group of kGroupLen targets whose min is `best`, and
  // (kTieMean) the last group whose min was <= `best` when it was walked;
  // otherwise the first index at `best`
  int first[kRq], last[kRq];
#pragma unroll
  for (int r = 0; r < kRq; ++r) {
    q[r] = Op::load_query(a, b, min(q0 + 32 * r, a.nq - 1));  // a spare lane repeats a query
    best[r] = CUDART_INF_F;
    first[r] = last[r] = 0;
  }

  // this warp's range of the slice
  const int c0 = slice * a.slice_len;
  const int c1 = min(a.nt, c0 + a.slice_len);
  const int sub = (c1 - c0 + W - 1) / W;
  const int w0 = min(c1, c0 + w * sub);
  const int w1 = min(c1, w0 + sub);
  float4(*tl)[kWarpTile] = reinterpret_cast<float4(*)[kWarpTile]>(smem + w * 2 * kWarpTile);
  auto stage = [&](int buf, int t0) {
    const int n = min(kWarpTile, w1 - t0);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      for (int k = lane; k < n; k += 32) {
        cp_async4(reinterpret_cast<float*>(&tl[buf][k]) + p, a.target.at(b, p, t0 + k));
      }
    }
    // a tile past the range's end: targets never nearest
    for (int k = n + lane; k < kWarpTile; k += 32) tl[buf][k] = Op::pad();
    cp_async_commit();
  };

  if (w0 < w1) stage(0, w0);
  for (int t0 = w0, it = 0; t0 < w1; t0 += kWarpTile, ++it) {
    const int buf = it & 1;
    if (t0 + kWarpTile < w1) {
      stage(buf ^ 1, t0 + kWarpTile);  // consumed in the last iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    Op::on_tile(tl[buf], min(kWarpTile, w1 - t0), lane);
    __syncwarp();
    const float4* tb = tl[buf];
    if constexpr (kGrouped) {
      // per group: its min by fminf (one instruction a pair; NaN distances
      // are passed over), then one compare and two selects a query
#pragma unroll 2
      for (int g = 0; g < kWarpTile; g += kGroupLen) {
        float gm[kRq];
#pragma unroll
        for (int u = 0; u < kGroupLen; ++u) {
          const float4 t = tb[g + u];
#pragma unroll
          for (int r = 0; r < kRq; ++r) {
            const float d = Op::tile_d2(q[r], t);
            gm[r] = u == 0 ? d : fminf(gm[r], d);
          }
        }
#pragma unroll
        for (int r = 0; r < kRq; ++r) {
          const bool lt = gm[r] < best[r];  // strict: the lowest index keeps a tie
          if constexpr (kPick == Pick::kTieMean) last[r] = gm[r] <= best[r] ? t0 + g : last[r];
          best[r] = lt ? gm[r] : best[r];
          first[r] = lt ? t0 + g : first[r];
        }
      }
    } else {  // one compare and two selects a pair: the exact index
#pragma unroll 4
      for (int j = 0; j < kWarpTile; ++j) {
        const float4 t = tb[j];
#pragma unroll
        for (int r = 0; r < kRq; ++r) {
          const float d = Op::tile_d2(q[r], t);
          const bool lt = d < best[r];  // strict: the lowest index keeps a tie
          best[r] = lt ? d : best[r];
          first[r] = lt ? t0 + j : first[r];
        }
      }
    }
    __syncwarp();  // this buffer is restaged in the next iteration
  }

  // The exact index (kLowest) or the payload sum (kTieMean) at `best`, from
  // the groups it was found in: the first target of group `first` at
  // exactly `best`, or every target of groups [first, last] at it, in order.
  Best mine[kRq];
#pragma unroll
  for (int r = 0; r < kRq; ++r) {
    Best& m = mine[r];
    m.d = best[r];
    m.i = 0;
    m.s0 = m.s1 = m.s2 = m.s3 = 0.0f;
    if (!(best[r] < CUDART_INF_F)) continue;
    if (kPick == Pick::kLowest && !kGrouped) {
      m.i = first[r];
    } else if constexpr (kPick == Pick::kLowest) {
      float tx[kGroupLen], ty[kGroupLen], tz[kGroupLen];
#pragma unroll
      for (int u = 0; u < kGroupLen; ++u) {  // loads in flight together
        const int k = min(first[r] + u, w1 - 1);
        tx[u] = *a.target.at(b, 0, k);
        ty[u] = *a.target.at(b, 1, k);
        tz[u] = *a.target.at(b, 2, k);
      }
      m.i = -1;
#pragma unroll
      for (int u = kGroupLen - 1; u >= 0; --u) {  // the lowest match wins
        if (Op::point_d2(q[r], tx[u], ty[u], tz[u]) == best[r] &&
            first[r] + u < w1) {
          m.i = first[r] + u;
        }
      }
    } else {
      for (int g = first[r]; g <= last[r]; g += kGroupLen) {  // once, without ties
        float tx[kGroupLen], ty[kGroupLen], tz[kGroupLen], tw[kGroupLen];
#pragma unroll
        for (int u = 0; u < kGroupLen; ++u) {  // loads in flight together
          const int k = min(g + u, w1 - 1);
          tx[u] = *a.target.at(b, 0, k);
          ty[u] = *a.target.at(b, 1, k);
          tz[u] = *a.target.at(b, 2, k);
          tw[u] = *a.target.at(b, 3, k);
        }
#pragma unroll
        for (int u = 0; u < kGroupLen; ++u) {  // ascending: the sum's order
          if (g + u >= w1 ||
              Op::point_d2(q[r], tx[u], ty[u], tz[u]) != best[r]) {
            continue;
          }
          if (m.i++ == 0) {
            m.s0 = tx[u];
            m.s1 = ty[u];
            m.s2 = tz[u];
            m.s3 = tw[u];
          } else {
            m.s0 = __fadd_rn(m.s0, tx[u]);
            m.s1 = __fadd_rn(m.s1, ty[u]);
            m.s2 = __fadd_rn(m.s2, tz[u]);
            m.s3 = __fadd_rn(m.s3, tw[u]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with its tiles: the results reuse them
  Best* red = reinterpret_cast<Best*>(smem);
#pragma unroll
  for (int r = 0; r < kRq; ++r) red[w * kGroup + lane + 32 * r] = mine[r];
  __syncthreads();
  if (w != 0) return;
  Best m[kRq];
#pragma unroll
  for (int r = 0; r < kRq; ++r) {
    m[r] = red[lane + 32 * r];
    for (int v = 1; v < W; ++v) merge_into<kPick>(m[r], red[v * kGroup + lane + 32 * r]);
  }
  if (a.slices == 1) {
    Op::template finish_group<kPick, kRq>(a, b, q0, q, m);
    return;
  }

  // this slice's partials, then the arrival count
#pragma unroll
  for (int r = 0; r < kRq; ++r) {
    const int i = q0 + 32 * r;
    if (i >= a.nq) continue;
    const size_t o = (static_cast<size_t>(b) * a.slices + slice) * a.nq + i;
    a.part_d[o] = m[r].d;
    a.part_i[o] = m[r].i;
    if constexpr (kPick == Pick::kTieMean) {
      float* ps = a.part_s + (static_cast<size_t>(b) * a.slices + slice) * 4 * a.nq + i;
      ps[0] = m[r].s0;
      ps[a.nq] = m[r].s1;
      ps[2 * a.nq] = m[r].s2;
      ps[3 * a.nq] = m[r].s3;
    }
  }
  __threadfence();  // the partials are visible before the arrival counts
  __syncwarp();
  unsigned is_last = 0;
  if (lane == 0) {
    uint32_t* arrived = a.arrivals + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
    is_last = atomicInc(arrived, static_cast<unsigned>(a.slices - 1)) ==
              static_cast<unsigned>(a.slices - 1);
  }
  if (!__shfl_sync(0xffffffffu, is_last, 0)) return;
  __threadfence();

  // the last block to arrive merges the slices in ascending order,
  // kMergeBatch slices' (min, count or index) at a time for all its queries
#pragma unroll
  for (int r = 0; r < kRq; ++r) {
    m[r].d = CUDART_INF_F;
    m[r].i = 0;
    m[r].s0 = m[r].s1 = m[r].s2 = m[r].s3 = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRq; ++r) {  // one query at a time: few live registers
    const int i = min(q0 + 32 * r, a.nq - 1);
    for (int cb = 0; cb < a.slices; cb += kMergeBatch) {
      float pd[kMergeBatch];
      int pi[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const size_t o = (static_cast<size_t>(b) * a.slices + cb + u) * a.nq + i;
        const bool in = cb + u < a.slices;
        pd[u] = in ? __ldcg(a.part_d + o) : CUDART_INF_F;
        pi[u] = in ? __ldcg(a.part_i + o) : 0;
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        Best p;
        p.d = pd[u];
        p.i = pi[u];
        p.s0 = p.s1 = p.s2 = p.s3 = 0.0f;
        if constexpr (kPick == Pick::kTieMean) {
          if (p.d <= m[r].d && p.i > 0) {  // taken or tied: its sums (rare)
            const float* ps =
                a.part_s + (static_cast<size_t>(b) * a.slices + cb + u) * 4 * a.nq + i;
            p.s0 = __ldcg(ps);
            p.s1 = __ldcg(ps + a.nq);
            p.s2 = __ldcg(ps + 2 * a.nq);
            p.s3 = __ldcg(ps + 3 * a.nq);
          }
        }
        merge_into<kPick>(m[r], p);
      }
    }
  }
  Op::template finish_group<kPick, kRq>(a, b, q0, q, m);
}

// A split geometry the kernel can run: 1-16 whole warps, and slices that
// cover [0, nt) with none empty.
inline bool split_geometry_ok(int nt, int threads, int slice_len, int slices) {
  return threads >= 32 && threads <= kSplitMaxWarps * 32 && threads % 32 == 0 &&
         slice_len >= 1 && slices >= 1 &&
         static_cast<long long>(slices) * slice_len >= nt &&
         static_cast<long long>(slices - 1) * slice_len < nt;
}

// The dynamic shared memory of a block: its warps' tiles, which their
// results reuse. At most 48 KB (16 warps of 4 queries a lane), so no kernel
// has to opt in to more.
inline size_t split_smem_bytes(int threads, int rq) {
  const size_t warps = threads / 32;
  const size_t tiles = warps * 2 * kWarpTile * sizeof(float4);
  const size_t results = warps * 32 * rq * sizeof(Best);
  return tiles > results ? tiles : results;
}
static_assert(kSplitMaxWarps * 32 * 4 * sizeof(Best) <= 48 * 1024 &&
                  kSplitMaxWarps * 2 * kWarpTile * sizeof(float4) <= 48 * 1024,
              "dynamic shared memory above 48 KB needs an opt-in");

constexpr int kGroupedFrom = 256;  // a warp's targets from which groups pay

template <Pick kPick, int kRq, class Op>
inline cudaError_t launch_rq(const typename Op::Args& a, dim3 grid, int threads,
                             size_t smem, cudaStream_t stream) {
  const int per_warp = (a.slice_len + threads / 32 - 1) / (threads / 32);
  if (kPick == Pick::kLowest && per_warp < kGroupedFrom) {  // the exact index
    nn_split_kernel<Op, Pick::kLowest, kRq, false><<<grid, threads, smem, stream>>>(a);
  } else {
    nn_split_kernel<Op, kPick, kRq, true><<<grid, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// Launches the kernel of policy Op for kRq in {2, 4} on grid (query
// groups, slices, lanes); returns the launch error. The caller checks the
// geometry.
template <Pick kPick, class Op = NnOp>
inline cudaError_t launch_split(const typename Op::Args& a, int lanes, int threads,
                                int rq, cudaStream_t stream) {
  const dim3 grid((a.nq + 32 * rq - 1) / (32 * rq), a.slices, lanes);
  const size_t smem = split_smem_bytes(threads, rq);
  if (rq == 2) return launch_rq<kPick, 2, Op>(a, grid, threads, smem, stream);
  if (rq == 4) return launch_rq<kPick, 4, Op>(a, grid, threads, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace scl
