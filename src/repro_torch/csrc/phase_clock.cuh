// Phase stamps of the large-n Householder solves (K11, K13), of the
// Cholesky solves on the tiled core (K10, K12, K14), of the Jacobi SVD
// (K8), of the chunked SSD scan (K21) and of the MMSE solves on a warp or
// a wide CTA (K2, K3, K5, K6).
//
// An instance compiled with kOn = true reads clock64() on thread 0 of the
// lane's first CTA at each phase edge, each edge right after a barrier
// (in a warp form, a __syncwarp) that ends the phase, and adds the cycles
// since the previous edge to that phase's sum.  So the phases tile the
// lane's time from its first stamp to its last: the sums add up to
// end - start exactly.  Only the phase-timing entry points
// (``*_phases_f32``), which scripts/qr_phases.py,
// scripts/chol_tiled_phases.py, scripts/svd_phases.py,
// scripts/ssm_phases.py and scripts/lane_phases.py call, launch such an
// instance; the served instances compile kOn = false, where every call
// below is empty.
#pragma once

namespace repro_torch {

// The cluster kernel splits its panels further: "gather" runs to each
// reflector's sums gathered (the cluster barrier's wait, and for a
// panel's first reflector the bands' loads and first sums), "dots" is
// the pass that applies it and sums the next one's, "panel" keeps the
// panel's end (its last column's copy and barrier).
enum QrPhase { kPhaseLoad, kPhasePanel, kPhaseVt, kPhaseApply,
               kPhaseBacksub, kPhaseGather, kPhaseDots, kQrPhases };

// Per lane: start, end, then the kQrPhases sums (cycles of the SM clock).
constexpr int kQrStampWords = 2 + kQrPhases;

// The tiled Cholesky core (tiled_chol.cuh): the load (A's lower triangle
// copied in, or K14's threshold), K14's Gram and matched filter; per
// panel the diagonal block (its copy in and its corners and rows, "diag",
// and its rank-4 updates, "update"), the rows of L21 (the column walk,
// "walk", and the rest: their copy in, scale, stores and rows of y,
// "rows") and the trailing update; per slab of the back substitution its
// sums over the rows below (K12, K14) and its diagonal block's solve; and
// per slab of K10's chain back substitution the rows above taking the
// slab's x ("chain").
enum TiledPhase { kTpLoad, kTpGram, kTpFilter, kTpDiag, kTpUpdate, kTpWalk,
                  kTpRows, kTpTrail, kTpSums, kTpBacksub, kTpChain,
                  kTiledPhases };
constexpr int kTiledStampWords = 2 + kTiledPhases;

// The one-sided Jacobi SVD (svd.cu): A copied in and V set to I; then per
// round of disjoint pairs the three sums of each pair (its columns' loads,
// the partial products and their reduction), the rotation's parameters,
// the rotation of A's and V's two columns, and the barrier that closes
// the round; last the epilogue (the norms, U's scaling and the stores).
enum SvdPhase { kSvLoad, kSvSums, kSvParams, kSvRotate, kSvBarrier,
                kSvEpilogue, kSvdPhases };
constexpr int kSvdStampWords = 2 + kSvdPhases;

// The chunked SSD scan (ssm_scan.cu), a CTA (a chunk of a lane at a time):
// the chunk's staging (its log-decays, C^T, B and first x tile), the
// log-decay scan, M^T built from G (and B scaled); then per tile of columns
// M x, the chunk's own state, the wait for h_{c-1}'s tile (and for the next
// rank's slot), the chain (h_c formed and sent on, or stored), C h_{c-1}
// with y stored, and the next x tile's stores.  The gram pass's CTAs are
// stamped apart (start and end).
enum ScanPhase { kSpLoad, kSpScan, kSpM, kSpMx, kSpState, kSpWait, kSpChain,
                 kSpCh, kSpX, kScanPhases };
constexpr int kScanStampWords = 2 + kScanPhases;

// The MMSE equalizers (K2, K3), the channel estimate (K5) and the PUSCH
// chain (K6), a lane on a warp (K2: or on a wide CTA): the load; the Gram
// and matched filter (K5, K6: the pilot Gram and cross product); the
// factor with its forward substitution; the back substitution; for K6's
// second chain its Gram of H and matched filter, factor and back
// substitution; the store.
enum LanePhase { kLpLoad, kLpGram, kLpFactor, kLpBack, kLpGram2, kLpFactor2,
                 kLpBack2, kLpStore, kLanePhases };
constexpr int kLaneStampWords = 2 + kLanePhases;

template <bool kOn, int kPhases = kQrPhases>
struct PhaseClock {
  long long start = 0, last = 0, sum[kPhases] = {};
  bool owner = false;

  __device__ explicit PhaseClock(bool lane_owner) {
    if (kOn) {
      owner = lane_owner && threadIdx.x == 0;
      if (owner) start = last = clock64();
    }
  }
  __device__ void mark(int p) {
    if (kOn && owner) {
      const long long now = clock64();
      sum[p] += now - last;
      last = now;
    }
  }
  __device__ void write(unsigned long long* out) const {
    if (kOn && owner) {
      out[0] = static_cast<unsigned long long>(start);
      out[1] = static_cast<unsigned long long>(last);
      for (int p = 0; p < kPhases; ++p)
        out[2 + p] = static_cast<unsigned long long>(sum[p]);
    }
  }
};

}  // namespace repro_torch
