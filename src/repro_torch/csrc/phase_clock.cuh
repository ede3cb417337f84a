// Phase stamps of the large-n Householder solves (K11, K13).
//
// An instance compiled with kOn = true reads clock64() on thread 0 of the
// lane's first CTA at each phase edge, each edge right after a barrier
// that ends the phase, and adds the cycles since the previous edge to that
// phase's sum.  So the phases tile the lane's time from its first stamp to
// its last: the sums add up to end - start exactly.  Only the phase-timing
// entry points (``*_phases_f32``), which scripts/qr_phases.py calls, launch
// such an instance; the served instances compile kOn = false, where every
// call below is empty.
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

template <bool kOn>
struct PhaseClock {
  long long start = 0, last = 0, sum[kQrPhases] = {};
  bool owner = false;

  __device__ explicit PhaseClock(bool lane_owner) {
    if (kOn) {
      owner = lane_owner && threadIdx.x == 0;
      if (owner) start = last = clock64();
    }
  }
  __device__ void mark(QrPhase p) {
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
      for (int p = 0; p < kQrPhases; ++p)
        out[2 + p] = static_cast<unsigned long long>(sum[p]);
    }
  }
};

}  // namespace repro_torch
