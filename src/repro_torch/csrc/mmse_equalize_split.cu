// K3: fused split re/im MMSE equalizer, one CTA per lane.
//
// Replaces: src/repro/pipelines/mmse.py, mmse_equalize_split_pallas
// (_mmse_split_kernel): the Gram matrix and matched filter of the complex
// system accumulated straight from the Re/Im planes
//   Gr = Hr^T Hr + Hi^T Hi   (one stacked sum over [Hr; Hi])
//   Gi = C - C^T,  C = Hr^T Hi
//   rhs = [Hs^T [yr; yi] ; Hs^T [yi; -yr]],  Hs = [Hr; Hi]
// and the real embedding [[Gr + sigma2 I, -Gi], [Gi, Gr + sigma2 I]]
// (2n x 2n) solved by the fused Cholesky chain of K1.  The output is the
// real-stacked (2n, k) = [Re x; Im x].
//
// What bounds it on an H100: each lane reads 2 m n + 2 m k floats and
// writes 2 n k; the least work is 2 m n (n + 1) (one triangle of Gr) +
// 2 m n^2 (C) + 8 m n k + (2n)^3/3 + 2 (2n)^2 k FLOPs.  Both bounds are
// small; the 4n-step ordered chain on the 2n x 2n embedding, a block
// barrier per step, is what holds it back.  The design builds only the
// lower triangle of the embedding (the chain never reads the upper half,
// which is where -Gi would go, so C is parked there on its way to Gi),
// keeps planes, system and right-hand sides in shared memory, and shares
// the chain with K1 and K2.
//
// A lane larger than shared memory (n > 96 at m = n + 4, k = 2) takes the
// global form: the four planes are read in place from device memory, the
// 2n x 2n embedding lives in a per-lane slice of a work buffer (1 MB a
// lane at n = 256) and x is solved in place in X.  After the same Gram
// stage it runs the panel chain (chol_panels.cuh): a panel of bs columns
// is factored in shared memory and the embedding's trailing lower
// triangle updated once a panel from register tiles, each product
// subtracted in chol_chain's order, so the global form equals the shared
// form bit for bit at every panel width.  The plan (threads, bs, shared
// memory) is pipelines/cholesky_solve.py's chol_panel_plan at (2n, k).
#include <cstddef>

#include "chol_panels.cuh"
#include "lane_common.cuh"

namespace repro_torch {
namespace {

template <bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kPanelThreads : kThreads,
                                  kGlobal ? kPanelMinBlocks : 0)
mmse_equalize_split_kernel(const float* __restrict__ Hr,
                           const float* __restrict__ Hi,
                           const float* __restrict__ Yr,
                           const float* __restrict__ Yi,
                           float* __restrict__ X, float* __restrict__ work,
                           int m, int n, int k, int bs, float sigma2,
                           float eps) {
  extern __shared__ float smem[];
  const int n2 = 2 * n;
  const size_t lane = blockIdx.x;
  const float* hr;             // m * n
  const float* hi;             // m * n
  const float* yr;             // m * k
  const float* yi;             // m * k
  float* g;                    // 2n * 2n
  float* rhs;                  // 2n * k
  float* col = nullptr;        // 2n (the shared form's chain scratch)
  if (kGlobal) {               // planes read in place, x solved in place
    hr = Hr + lane * m * n;
    hi = Hi + lane * m * n;
    yr = Yr + lane * m * k;
    yi = Yi + lane * m * k;
    g = work + lane * n2 * n2;
    rhs = X + lane * n2 * k;
  } else {
    float* hrs = smem;
    float* his = hrs + m * n;
    float* yrs = his + m * n;
    float* yis = yrs + m * k;
    for (int e = threadIdx.x; e < m * n; e += blockDim.x) {
      hrs[e] = Hr[lane * m * n + e];
      his[e] = Hi[lane * m * n + e];
    }
    for (int e = threadIdx.x; e < m * k; e += blockDim.x) {
      yrs[e] = Yr[lane * m * k + e];
      yis[e] = Yi[lane * m * k + e];
    }
    hr = hrs;
    hi = his;
    yr = yrs;
    yi = yis;
    g = yis + m * k;
    rhs = g + n2 * n2;
    col = rhs + n2 * k;
    __syncthreads();
  }
  // split Gram region: Gr into both diagonal blocks (lower triangles), and
  // C = Hr^T Hi, each entry once, into the upper-right block, which the
  // chain never reads
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    if (j <= i) {
      float s = 0.0f;
      for (int r = 0; r < m; ++r) s += hr[r * n + i] * hr[r * n + j];
      for (int r = 0; r < m; ++r) s += hi[r * n + i] * hi[r * n + j];
      if (i == j) s += sigma2;
      g[i * n2 + j] = s;
      g[(i + n) * n2 + (j + n)] = s;
    }
    float c = 0.0f;
    for (int r = 0; r < m; ++r) c += hr[r * n + i] * hi[r * n + j];
    g[i * n2 + (j + n)] = c;
  }
  // split matched filter: rr = Hr^T yr + Hi^T yi, ri = Hr^T yi - Hi^T yr
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float rr = 0.0f;
    for (int r = 0; r < m; ++r) rr += hr[r * n + i] * yr[r * k + c];
    for (int r = 0; r < m; ++r) rr += hi[r * n + i] * yi[r * k + c];
    float ri = 0.0f;
    for (int r = 0; r < m; ++r) ri += hr[r * n + i] * yi[r * k + c];
    for (int r = 0; r < m; ++r) ri += hi[r * n + i] * -yr[r * k + c];
    rhs[i * k + c] = rr;
    rhs[(i + n) * k + c] = ri;
  }
  __syncthreads();
  // Gi = C - C^T into the whole lower-left block.  Entries go out along
  // diagonals (j = i + d mod n) so that, at n = 32, a warp's reads of C
  // and of C^T both fall in distinct banks.
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e % n;
    const int j = (e / n + i) % n;
    g[(i + n) * n2 + j] = g[i * n2 + (j + n)] - g[j * n2 + (i + n)];
  }
  __syncthreads();
  if (kGlobal) {
    chol_chain_panels(g, g, rhs, n2, k, bs, eps, smem);
  } else {
    float* yk = col + n2;      // k
    float* thresh = yk + k;    // 1
    chol_chain(g, rhs, n2, k, eps, col, yk, thresh);
    float* xl = X + lane * n2 * k;
    for (int e = threadIdx.x; e < n2 * k; e += blockDim.x) xl[e] = rhs[e];
  }
}

size_t smem_bytes(int m, int n, int k) {
  const size_t n2 = 2 * static_cast<size_t>(n);
  return sizeof(float) *
         (2 * static_cast<size_t>(m) * n + 2 * m * k + n2 * n2 + n2 * k +
          n2 + k + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t mmse_equalize_split_smem(int m, int n, int k) {
  return repro_torch::smem_bytes(m, n, k);
}

// Dynamic shared memory one lane of the global form needs at panel width bs
// (the panel chain on the 2n x 2n embedding).
size_t mmse_equalize_split_global_smem(int m, int n, int k, int bs) {
  return repro_torch::chol_panel_smem_bytes(2 * n, k, bs);
}

// Floats of work buffer one lane of the global form needs (the 2n x 2n
// embedding).
size_t mmse_equalize_split_work(int m, int n, int k) {
  return 4 * static_cast<size_t>(n) * n;
}

// hr, hi (batch, m, n), yr, yi (batch, m, k) -> x (batch, 2n, k), float32.
// work: null for the shared form, else batch * mmse_equalize_split_work
// floats and the global form's plan (pipelines/cholesky_solve.py
// chol_panel_plan at (2n, k): threads, panel width bs, smem bytes),
// refused unless it is one the panel chain was compiled for.  The shared
// form ignores the plan.
int mmse_equalize_split_f32(const void* hr, const void* hi, const void* yr,
                            const void* yi, void* x, void* work, int batch,
                            int m, int n, int k, float sigma2, float eps,
                            int threads, int bs, int smem, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* hrf = static_cast<const float*>(hr);
  const float* hif = static_cast<const float*>(hi);
  const float* yrf = static_cast<const float*>(yr);
  const float* yif = static_cast<const float*>(yi);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (work) {
    if (!chol_panel_plan_ok(2 * n, k, threads, bs, smem))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(mmse_equalize_split_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    mmse_equalize_split_kernel<true><<<batch, threads, smem, s>>>(
        hrf, hif, yrf, yif, xf, wf, m, n, k, bs, sigma2, eps);
    return cudaGetLastError();
  }
  const size_t smem_shared = smem_bytes(m, n, k);
  cudaError_t err =
      allow_smem(mmse_equalize_split_kernel<false>, smem_shared);
  if (err != cudaSuccess) return err;
  mmse_equalize_split_kernel<false><<<batch, kThreads, smem_shared, s>>>(
      hrf, hif, yrf, yif, xf, wf, m, n, k, 0, sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
