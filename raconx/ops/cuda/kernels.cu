// Banded alignment kernels for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (raconx/ops/cuda_kernels.py builds and
// registers them).
//
// Every kernel reproduces its plain jax.numpy twin bit for bit:
//   raconx_nw_band      <-> nw_kernel.nw_band_batch_ref   (scored banded NW)
//   raconx_myers_sweep  <-> myers_kernel.myers_sweep_ref  (Myers bit-vector)
//   raconx_nw_walk      <-> nw_kernel.walk_moves_device   (scored traceback)
//   raconx_myers_walk   <-> myers_kernel.myers_walk_ref   (Myers traceback)
// Every value is an integer, so the contract is exact equality.
//
// Layout: one warp per alignment. The band lives in the warp's registers
// and the kernel loops over all query rows inside the warp, so H (or the
// Myers PV/MV vectors) never leaves the chip between rows.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kPad = 5;          // nw_kernel.PAD_CODE
constexpr int kNeg = -100000;    // nw_kernel.NEG
constexpr int kPack = 16;        // query rows per packed move word
constexpr int kCodes = 6;        // ACGTN + PAD
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------------
// Scored banded NW sweep.
//
// Band lane k <-> target column j = i + dlo + k. Lane `l` of the warp owns
// the VPL consecutive band lanes k = l*VPL + v, so the row's horizontal
// max-plus closure is a VPL-long serial prefix inside each lane followed by
// a 5-step shuffle scan across lanes. The target codes and cumulative
// deletion costs of the band window are held in registers and advance one
// column per row (one shuffle each, one load by the top lane).
// Moves: 2 bits per cell, 16 rows per int32 word, layout (B, m_cap/16, W).
// ------------------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(128)
nw_band_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
               const int32_t* __restrict__ gc, int32_t* __restrict__ moves,
               int32_t* __restrict__ score, int batch, int m_cap, int n_cap,
               int match, int mismatch, int gap) {
  constexpr int W = 32 * VPL;
  const int item = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= batch) return;  // whole warps only: batch is per warp
  const int8_t* qb = q + static_cast<size_t>(item) * m_cap;
  const int8_t* tb = t + static_cast<size_t>(item) * n_cap;
  const int32_t* gb = gc + static_cast<size_t>(item) * (n_cap + 1);
  int32_t* mb = moves + static_cast<size_t>(item) * (m_cap / kPack) * W;
  const int dlo = n_cap - m_cap - W / 2;
  const int k0 = lane * VPL;
  const int gc_end = gb[n_cap];

  int H[VPL], T[VPL], G[VPL], P[VPL], A[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j0 = dlo + k0 + v;  // row 0
    H[v] = (j0 >= 0 && j0 <= n_cap) ? gb[j0] : kNeg;
    const int j = j0 + 1;         // row 1 window
    T[v] = (j >= 1 && j <= n_cap) ? tb[j - 1] : kPad;
    G[v] = j < 0 ? 0 : (j > n_cap ? gc_end : gb[j]);
    P[v] = 0;
  }

  for (int i = 1; i <= m_cap; ++i) {
    const int qi = qb[i - 1];
    const bool qpad = qi == kPad;
    const int jb = i + dlo + k0;
    int hnext = __shfl_down_sync(kFull, H[0], 1);  // H[k + 1] across lanes
    if (lane == 31) hnext = kNeg;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = jb + v;
      const bool valid = j >= 1 && j <= n_cap;
      const int sub = ((T[v] == kPad) != qpad) ? kNeg
                      : (T[v] == qi ? match : mismatch);
      int c = max(H[v] + sub, (v + 1 < VPL ? H[v + 1] : hnext) + gap);
      if (j == 0) c = i * gap;
      if (!(valid || j == 0)) c = kNeg;
      A[v] = c - G[v];
    }
    // inclusive prefix max over the whole band
#pragma unroll
    for (int v = 1; v < VPL; ++v) A[v] = max(A[v], A[v - 1]);
    int tot = A[VPL - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, tot, o);
      if (lane >= o) tot = max(tot, y);
    }
    const int ex = __shfl_up_sync(kFull, tot, 1);
    const int sh = 2 * ((i - 1) & (kPack - 1));
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = jb + v;
      const bool valid = j >= 1 && j <= n_cap;
      const int sub = ((T[v] == kPad) != qpad) ? kNeg
                      : (T[v] == qi ? match : mismatch);
      const int d = H[v] + sub;  // H[v + 1] is still the previous row's
      const int u = (v + 1 < VPL ? H[v + 1] : hnext) + gap;
      int h = (lane > 0 ? max(A[v], ex) : A[v]) + G[v];
      if (!(valid || j == 0)) h = kNeg;
      int mv = h == d ? 0 : (h == u ? 1 : 2);
      if (!valid) mv = 3;
      P[v] |= mv << sh;
      H[v] = h;
    }
    if (sh == 2 * (kPack - 1)) {
      int32_t* row = mb + static_cast<size_t>((i - 1) / kPack) * W + k0;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        row[v] = P[v];
        P[v] = 0;
      }
    }
    // advance the target / cost window by one column
    int tn = __shfl_down_sync(kFull, T[0], 1);
    int gn = __shfl_down_sync(kFull, G[0], 1);
    if (lane == 31) {
      const int j = i + 1 + dlo + W - 1;
      tn = (j >= 1 && j <= n_cap) ? tb[j - 1] : kPad;
      gn = j < 0 ? 0 : (j > n_cap ? gc_end : gb[j]);
    }
#pragma unroll
    for (int v = 0; v + 1 < VPL; ++v) {
      T[v] = T[v + 1];
      G[v] = G[v + 1];
    }
    T[VPL - 1] = tn;
    G[VPL - 1] = gn;
  }
  const int k_end = n_cap - m_cap - dlo;
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    if (k0 + v == k_end) score[item] = H[v];
}

// ------------------------------------------------------------------------
// Myers bit-vector banded edit distance (Hyyro's banded variant).
//
// One warp per alignment; the W-bit band is NW 32-bit words, WPL words per
// lane (lanes beyond NW/WPL idle at small bands). The row's W-bit add
// carries across lanes by a ballot carry-lookahead, the 1-bit shifts by one
// shuffle each. Peq (one bitmask per code over the guard-padded target) is
// built per item in shared memory with ballots. Output planes per row:
// DIAG = Eq | ~D0 and UP = HP, layout (B, m_cap, 2, NW).
// ------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mask_ge(int pos, int word) {
  const int sh = pos - 32 * word;
  if (sh <= 0) return kFull;
  if (sh >= 32) return 0u;
  return kFull << sh;
}

__device__ __forceinline__ uint32_t onehot(int pos, int word) {
  const int rel = pos - 32 * word;
  return (rel >= 0 && rel < 32) ? (1u << rel) : 0u;
}

template <int NW>
__global__ void __launch_bounds__(32)
myers_sweep_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   uint32_t* __restrict__ planes, int m_cap, int n_cap,
                   int nwp) {
  constexpr int WPL = NW >= 32 ? NW / 32 : 1;
  constexpr int ACTIVE = NW / WPL;
  constexpr int W = 32 * NW;
  extern __shared__ uint32_t peq[];  // [kCodes][nwp]
  const int item = blockIdx.x;
  const int lane = threadIdx.x;
  const int guard = W / 2 + 32;
  const int dlo = n_cap - m_cap - W / 2;
  const int8_t* qb = q + static_cast<size_t>(item) * m_cap;
  const int8_t* tb = t + static_cast<size_t>(item) * n_cap;

  for (int w = 0; w < nwp; ++w) {
    const int p = 32 * w + lane - guard;
    const int c = (p >= 0 && p < n_cap) ? tb[p] : -1;
#pragma unroll
    for (int cc = 0; cc < kCodes; ++cc) {
      const unsigned bits = __ballot_sync(kFull, c == cc);
      if (lane == cc) peq[cc * nwp + w] = bits;
    }
  }
  __syncwarp();

  const bool active = lane < ACTIVE;
  const int wb = lane * WPL;  // this lane's first word
  uint32_t PV[WPL], MV[WPL];
#pragma unroll
  for (int v = 0; v < WPL; ++v) {
    PV[v] = active ? mask_ge(-dlo, wb + v) : 0u;
    MV[v] = 0u;
  }
  uint32_t* out = planes + static_cast<size_t>(item) * m_cap * 2 * NW;

  for (int i = 1; i <= m_cap; ++i) {
    const int kz = -(i + dlo);  // band bit of the j = 0 boundary column
    const int pos0 = i + dlo - 1 + guard;
    // idle lanes read in range and discard it
    const uint32_t* plane =
        peq + qb[i - 1] * nwp + (pos0 >> 5) + (active ? wb : 0);
    const int r = pos0 & 31;
    uint32_t X[WPL], S[WPL], D0[WPL], HP[WPL], HN[WPL], EQ[WPL];
    uint32_t carry = 0;
#pragma unroll
    for (int v = 0; v < WPL; ++v) {
      uint32_t eq = __funnelshift_r(plane[v], plane[v + 1], r);
      if (!active) eq = 0u;
      // bits at or below the boundary lane start the add with carry 0
      const uint32_t keep = mask_ge(kz + 1, wb + v);
      eq &= keep;
      PV[v] &= keep;
      MV[v] &= keep;
      EQ[v] = eq;
      X[v] = eq | MV[v];
      const uint64_t s = static_cast<uint64_t>(X[v] & PV[v]) + PV[v] + carry;
      S[v] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    bool all_ones = active;
#pragma unroll
    for (int v = 0; v < WPL; ++v) all_ones = all_ones && S[v] == kFull;
    const unsigned gen = __ballot_sync(kFull, active && carry);
    const unsigned prop = __ballot_sync(kFull, all_ones);
    uint32_t cin = (((gen + (gen | prop)) ^ prop) >> lane) & 1u;
#pragma unroll
    for (int v = 0; v < WPL; ++v) {
      const uint64_t s = static_cast<uint64_t>(S[v]) + cin;
      S[v] = static_cast<uint32_t>(s);
      cin = static_cast<uint32_t>(s >> 32);
    }
    uint32_t* row = out + static_cast<size_t>(i - 1) * 2 * NW + wb;
#pragma unroll
    for (int v = 0; v < WPL; ++v) {
      D0[v] = (S[v] ^ PV[v]) | X[v];
      HN[v] = PV[v] & D0[v];
      HP[v] = MV[v] | ~(PV[v] | D0[v]);
      const uint32_t oh = onehot(kz, wb + v);
      HP[v] |= oh;
      HN[v] &= ~oh;
      if (active) {
        row[v] = EQ[v] | ~D0[v];
        row[NW + v] = HP[v];
      }
    }
    // X2 = HP << 1 and HN << 1 across the whole band
    uint32_t hp_in = __shfl_up_sync(kFull, HP[WPL - 1], 1);
    uint32_t hn_in = __shfl_up_sync(kFull, HN[WPL - 1], 1);
    if (lane == 0) hp_in = hn_in = 0u;
    uint32_t PVn[WPL], MVn[WPL];
#pragma unroll
    for (int v = 0; v < WPL; ++v) {
      const uint32_t lo_hp = v ? HP[v - 1] : hp_in;
      const uint32_t lo_hn = v ? HN[v - 1] : hn_in;
      const uint32_t X2 = (HP[v] << 1) | (lo_hp >> 31);
      const uint32_t HN2 = (HN[v] << 1) | (lo_hn >> 31);
      PVn[v] = HN2 | ~(D0[v] | X2);
      MVn[v] = D0[v] & X2;
    }
    // band shift to the next row: one bit toward lower lanes, the top bit
    // filled with PV = 1 / MV = 0
    uint32_t pv_in = __shfl_down_sync(kFull, PVn[0], 1);
    uint32_t mv_in = __shfl_down_sync(kFull, MVn[0], 1);
    if (lane == ACTIVE - 1) {
      pv_in = 1u;
      mv_in = 0u;
    }
#pragma unroll
    for (int v = 0; v < WPL; ++v) {
      const uint32_t hi_pv = v + 1 < WPL ? PVn[v + 1] : pv_in;
      const uint32_t hi_mv = v + 1 < WPL ? MVn[v + 1] : mv_in;
      PV[v] = active ? (PVn[v] >> 1) | (hi_pv << 31) : 0u;
      MV[v] = active ? (MVn[v] >> 1) | (hi_mv << 31) : 0u;
    }
  }
}

// ------------------------------------------------------------------------
// Tracebacks. Both reproduce their jnp twins' payload bytes exactly:
//   raconx_nw_walk     <-> nw_kernel.walk_moves_device (packed, + escape)
//   raconx_myers_walk  <-> myers_kernel.myers_walk_ref
// ------------------------------------------------------------------------

// Scored walk: one thread per item, backward from (m, n) over the packed
// moves; 2-bit op stream (0 diag, 1 up, 2 left, 3 skip) 4 steps per byte,
// then the escape byte. Steps after the walk ends stay skip (0b11).
__global__ void __launch_bounds__(128)
nw_walk_kernel(const int32_t* __restrict__ moves, const int32_t* __restrict__ m,
               const int32_t* __restrict__ n, uint8_t* __restrict__ payload,
               int batch, int m_cap, int n_cap, int w_band, int max_steps) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  const int W = w_band;
  const int dlo = n_cap - m_cap - W / 2;
  const int32_t* mb = moves + static_cast<size_t>(item) * (m_cap / kPack) * W;
  const int width = max_steps / 4 + 1;
  uint8_t* out = payload + static_cast<size_t>(item) * width;
  int i = m[item], j = n[item];
  bool esc = false;
  int s = 0;
  unsigned byte = 0;
  for (; s < max_steps && (i != 0 || j != 0); ++s) {
    const int k = j - i - dlo;
    int mv;
    if (i == 0) {
      mv = 2;
    } else if (j == 0) {
      mv = 1;
    } else {
      const int row = i - 1;
      const int kc = min(max(k, 0), W - 1);
      mv = (mb[(row / kPack) * W + kc] >> (2 * (row % kPack))) & 3;
      if (k < 0 || k >= W || mv == 3) {
        esc = true;
        break;
      }
    }
    byte |= static_cast<unsigned>(mv) << (2 * (s & 3));
    if ((s & 3) == 3) {
      out[s >> 2] = static_cast<uint8_t>(byte);
      byte = 0;
    }
    i -= (mv == 0 || mv == 1);
    j -= (mv == 0 || mv == 2);
  }
  if (s & 3) {  // finish the partial byte with skips
    byte |= (0xFFu << (2 * (s & 3))) & 0xFFu;
    out[s >> 2] = static_cast<uint8_t>(byte);
    s = (s | 3) + 1;
  }
  for (int p = s >> 2; p < max_steps / 4; ++p) out[p] = 0xFF;
  out[width - 1] = (esc || i != 0 || j != 0) ? 1 : 0;
}

// Myers walk: one warp per item, backward over the DIAG/UP planes one query
// row at a time; the exit lane is the highest non-LEFT bit at or below the
// current lane (per-word highest set bit, then a warp max). One record byte
// per row (1 diag / 2 up, deletions << 2; 0 inactive), then the final
// deletions byte and the escape byte.
template <int NW>
__global__ void __launch_bounds__(32)
myers_walk_kernel(const uint32_t* __restrict__ planes,
                  const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                  uint8_t* __restrict__ payload, int m_cap, int n_cap) {
  constexpr int WPL = NW >= 32 ? NW / 32 : 1;
  constexpr int ACTIVE = NW / WPL;
  constexpr int W = 32 * NW;
  const int item = blockIdx.x;
  const int lane = threadIdx.x;
  const bool active_lane = lane < ACTIVE;
  const int wb = active_lane ? lane * WPL : 0;
  const int dlo = n_cap - m_cap - W / 2;
  const int mi = m[item];
  const uint32_t* pb = planes + static_cast<size_t>(item) * m_cap * 2 * NW;
  uint8_t* out = payload + static_cast<size_t>(item) * (m_cap + 2);
  int kvec = n[item] - mi - dlo;
  bool esc = false;
  unsigned mine = 0;  // record of row (i - 1) when (i - 1) % 32 == lane
  for (int i = m_cap; i >= 1; --i) {
    unsigned rec = 0;
    if (i <= mi && !esc) {
      const int kz = -(i + dlo);
      const uint32_t* row = pb + static_cast<size_t>(i - 1) * 2 * NW + wb;
      int best = -1;
      uint32_t dg[WPL], up[WPL];
#pragma unroll
      for (int v = 0; v < WPL; ++v) {
        const uint32_t oh = onehot(kz, wb + v);
        dg[v] = active_lane ? row[v] & ~oh : 0u;
        up[v] = active_lane ? row[NW + v] | oh : 0u;
        // bits <= kvec of this word
        const int sh = kvec - 32 * (wb + v) + 1;
        const uint32_t le = sh >= 32 ? kFull : (sh <= 0 ? 0u : kFull >> (32 - sh));
        const uint32_t masked = (dg[v] | up[v]) & le;
        if (masked) best = 32 * (wb + v) + 31 - __clz(masked);
      }
      if (!active_lane) best = -1;
      const int k_exit = __reduce_max_sync(kFull, best);
      bool dh = false, uh = false;
#pragma unroll
      for (int v = 0; v < WPL; ++v) {
        const int rel = k_exit - 32 * (wb + v);
        if (active_lane && rel >= 0 && rel < 32) {
          dh = (dg[v] >> rel) & 1u;
          uh = (up[v] >> rel) & 1u;
        }
      }
      const bool diag_hit = __any_sync(kFull, dh);
      const bool up_hit = __any_sync(kFull, uh);
      const int nleft = kvec - k_exit;
      const bool inband = kvec >= 0 && kvec < W;
      if (!inband || k_exit < 0 || nleft > 63) {
        esc = true;
      } else {
        rec = (diag_hit ? 1u : 2u) | (static_cast<unsigned>(nleft) << 2);
        kvec = k_exit + ((up_hit && !diag_hit) ? 1 : 0);
      }
    }
    if (lane == ((i - 1) & 31)) mine = rec;
    if (((i - 1) & 31) == 0) {
      out[i - 1 + lane] = static_cast<uint8_t>(mine);
      mine = 0;
    }
  }
  if (lane == 0) {
    const int jfin = dlo + kvec;
    const bool esc2 = esc || jfin < 0 || jfin > 255;
    out[m_cap] = static_cast<uint8_t>(min(max(jfin, 0), 255));
    out[m_cap + 1] = esc2 ? 1 : 0;
  }
}

// ------------------------------------------------------------------------
// FFI handlers
// ------------------------------------------------------------------------

ffi::Error launch_status(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

template <int VPL>
void launch_nw(cudaStream_t s, const int8_t* q, const int8_t* t,
               const int32_t* gc, int32_t* moves, int32_t* score, int batch,
               int m_cap, int n_cap, int match, int mismatch, int gap) {
  constexpr int kWarps = 4;
  const int blocks = (batch + kWarps - 1) / kWarps;
  nw_band_kernel<VPL><<<blocks, 32 * kWarps, 0, s>>>(
      q, t, gc, moves, score, batch, m_cap, n_cap, match, mismatch, gap);
}

ffi::Error NwBandImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                      ffi::Buffer<ffi::S8> t, ffi::Buffer<ffi::S32> gc,
                      ffi::ResultBuffer<ffi::S32> moves,
                      ffi::ResultBuffer<ffi::S32> score, int32_t w_band,
                      int32_t match, int32_t mismatch, int32_t gap) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0])
    return ffi::Error::InvalidArgument("nw_band: q/t must be (B, cap)");
  const int batch = static_cast<int>(qd[0]);
  const int m_cap = static_cast<int>(qd[1]);
  const int n_cap = static_cast<int>(td[1]);
  if (m_cap % kPack)
    return ffi::Error::InvalidArgument("nw_band: m_cap % 16 != 0");
  if (batch == 0) return ffi::Error::Success();
  auto* mv = moves->typed_data();
  auto* sc = score->typed_data();
  switch (w_band) {
#define RACONX_NW_CASE(WB)                                                 \
  case WB:                                                                 \
    launch_nw<WB / 32>(stream, q.typed_data(), t.typed_data(),             \
                       gc.typed_data(), mv, sc, batch, m_cap, n_cap,       \
                       match, mismatch, gap);                              \
    break;
    RACONX_NW_CASE(64)
    RACONX_NW_CASE(128)
    RACONX_NW_CASE(256)
    RACONX_NW_CASE(384)
    RACONX_NW_CASE(512)
    RACONX_NW_CASE(768)
    RACONX_NW_CASE(1024)
    RACONX_NW_CASE(2048)
#undef RACONX_NW_CASE
    default:
      return ffi::Error::InvalidArgument("nw_band: unsupported band " +
                                         std::to_string(w_band));
  }
  return launch_status("nw_band");
}

template <int NW>
void launch_myers(cudaStream_t s, const int8_t* q, const int8_t* t,
                  uint32_t* planes, int batch, int m_cap, int n_cap,
                  int nwp) {
  const size_t smem = sizeof(uint32_t) * kCodes * nwp;
  myers_sweep_kernel<NW><<<batch, 32, smem, s>>>(q, t, planes, m_cap, n_cap,
                                                 nwp);
}

ffi::Error MyersSweepImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                          ffi::Buffer<ffi::S8> t,
                          ffi::ResultBuffer<ffi::S32> planes,
                          int32_t w_band) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0])
    return ffi::Error::InvalidArgument("myers_sweep: q/t must be (B, cap)");
  const int batch = static_cast<int>(qd[0]);
  const int m_cap = static_cast<int>(qd[1]);
  const int n_cap = static_cast<int>(td[1]);
  const int guard = w_band / 2 + 32;
  if (m_cap != n_cap || n_cap % 32 || w_band % 64)
    return ffi::Error::InvalidArgument("myers_sweep: unsupported shape");
  const int nwp = (n_cap + 2 * guard) / 32;
  const size_t smem = sizeof(uint32_t) * kCodes * nwp;
  if (smem > 48 * 1024)
    return ffi::Error::InvalidArgument("myers_sweep: Peq exceeds 48 KB");
  if (batch == 0) return ffi::Error::Success();
  auto* out = reinterpret_cast<uint32_t*>(planes->typed_data());
  switch (w_band / 32) {
#define RACONX_MYERS_CASE(NW)                                              \
  case NW:                                                                 \
    launch_myers<NW>(stream, q.typed_data(), t.typed_data(), out, batch,   \
                     m_cap, n_cap, nwp);                                   \
    break;
    RACONX_MYERS_CASE(2)
    RACONX_MYERS_CASE(4)
    RACONX_MYERS_CASE(8)
    RACONX_MYERS_CASE(16)
    RACONX_MYERS_CASE(32)
    RACONX_MYERS_CASE(64)
    RACONX_MYERS_CASE(128)
#undef RACONX_MYERS_CASE
    default:
      return ffi::Error::InvalidArgument("myers_sweep: unsupported band " +
                                         std::to_string(w_band));
  }
  return launch_status("myers_sweep");
}

ffi::Error NwWalkImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> moves,
                      ffi::Buffer<ffi::S32> m, ffi::Buffer<ffi::S32> n,
                      ffi::ResultBuffer<ffi::U8> payload, int32_t m_cap,
                      int32_t n_cap, int32_t w_band, int32_t max_steps) {
  const auto md = moves.dimensions();
  if (md.size() != 3 || md[1] != m_cap / kPack || md[2] != w_band ||
      max_steps % 4)
    return ffi::Error::InvalidArgument("nw_walk: unexpected shapes");
  const int batch = static_cast<int>(md[0]);
  if (batch == 0) return ffi::Error::Success();
  nw_walk_kernel<<<(batch + 127) / 128, 128, 0, stream>>>(
      moves.typed_data(), m.typed_data(), n.typed_data(),
      payload->typed_data(), batch, m_cap, n_cap, w_band, max_steps);
  return launch_status("nw_walk");
}

ffi::Error MyersWalkImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> planes,
                         ffi::Buffer<ffi::S32> m, ffi::Buffer<ffi::S32> n,
                         ffi::ResultBuffer<ffi::U8> payload, int32_t n_cap) {
  const auto pd = planes.dimensions();
  if (pd.size() != 4 || pd[2] != 2 || pd[1] % 32)
    return ffi::Error::InvalidArgument("myers_walk: unexpected shapes");
  const int batch = static_cast<int>(pd[0]);
  const int m_cap = static_cast<int>(pd[1]);
  const int nw = static_cast<int>(pd[3]);
  if (batch == 0) return ffi::Error::Success();
  auto* pl = reinterpret_cast<const uint32_t*>(planes.typed_data());
  switch (nw) {
#define RACONX_WALK_CASE(NW)                                                \
  case NW:                                                                  \
    myers_walk_kernel<NW><<<batch, 32, 0, stream>>>(                        \
        pl, m.typed_data(), n.typed_data(), payload->typed_data(), m_cap,   \
        n_cap);                                                             \
    break;
    RACONX_WALK_CASE(2)
    RACONX_WALK_CASE(4)
    RACONX_WALK_CASE(8)
    RACONX_WALK_CASE(16)
    RACONX_WALK_CASE(32)
    RACONX_WALK_CASE(64)
    RACONX_WALK_CASE(128)
#undef RACONX_WALK_CASE
    default:
      return ffi::Error::InvalidArgument("myers_walk: unsupported band");
  }
  return launch_status("myers_walk");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RaconxNwWalk, NwWalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("m_cap")
                                  .Attr<int32_t>("n_cap")
                                  .Attr<int32_t>("w_band")
                                  .Attr<int32_t>("max_steps"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RaconxMyersWalk, MyersWalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("n_cap"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RaconxNwBand, NwBandImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("w_band")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RaconxMyersSweep, MyersSweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("w_band"));
