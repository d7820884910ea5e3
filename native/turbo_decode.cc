// Native max-log-MAP turbo decoder — the host-side "plain C" decode path
// (the reference's capability anchor: ">25 Mbps turbo decoding in standard
// C", README.md:18; the SIMD path maps to the Pallas GPU kernel in
// srsue_tpu/phy/turbo_pallas.py). Also serves as an INDEPENDENT
// implementation of the BCJR recursions for cross-checking the JAX/Pallas
// decoders (full non-windowed recursion, distinct code lineage from
// phy/turbo.py).
//
// Conventions match the device decoders exactly:
//   * LLR sign: positive LLR => bit 0 (demodulate_soft convention);
//   * d layout: [3][k+4] row-major (sys | par1 | par2, tails multiplexed
//     per 36.212 §5.1.3.2.2 — same layout turbo_encode() emits);
//   * gamma(s,u) = 0.5*(u_sign[u]*Lin + p_sign[s][u]*Par).
//
// Exposed via the plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float NEG = -1e30f;

// LTE RSC constituent (g0=13, g1=15 octal): state s = (r1 r2 r3).
struct Trellis {
  int ns[8][2];      // next state for input u
  float psign[8][2]; // 1-2*parity
  float usign[2] = {1.0f, -1.0f};
  // deterministic termination transition (input u = r2^r3)
  int tail_ns[8];
  float tail_usign[8];
  float tail_psign[8];
  Trellis() {
    for (int s = 0; s < 8; ++s) {
      int r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
      for (int u = 0; u < 2; ++u) {
        int a = u ^ r2 ^ r3;
        int p = a ^ r1 ^ r3;
        ns[s][u] = (a << 2) | (r1 << 1) | r2;
        psign[s][u] = 1.0f - 2.0f * p;
      }
      int u = r2 ^ r3;           // termination input: a == 0
      int p = r1 ^ r3;
      tail_ns[s] = (r1 << 1) | r2;
      tail_usign[s] = 1.0f - 2.0f * u;
      tail_psign[s] = 1.0f - 2.0f * p;
    }
  }
};
const Trellis TR;

inline float fmaxf2(float a, float b) { return a > b ? a : b; }

// beta at t=k from the 3 deterministic tail steps.
void tail_beta(const float ts[3], const float tp[3], float beta[8]) {
  float b[8], nb[8];
  for (int s = 0; s < 8; ++s) b[s] = (s == 0) ? 0.0f : NEG;
  for (int i = 2; i >= 0; --i) {
    for (int s = 0; s < 8; ++s) {
      float g = 0.5f * (TR.tail_usign[s] * ts[i] + TR.tail_psign[s] * tp[i]);
      nb[s] = g + b[TR.tail_ns[s]];
    }
    std::memcpy(b, nb, sizeof(b));
  }
  std::memcpy(beta, b, sizeof(nb));
}

// One constituent max-log BCJR: Lin = sys + apriori, Par = parity.
// Writes extrinsic into ext (Le = L_posterior - Lin).
void bcjr_half(const float* lin, const float* par, int k,
               const float beta_k[8], float* alpha_store, float* ext) {
  // forward
  float a[8], na[8];
  for (int s = 0; s < 8; ++s) a[s] = (s == 0) ? 0.0f : NEG;
  for (int t = 0; t < k; ++t) {
    std::memcpy(alpha_store + 8 * t, a, sizeof(a));
    for (int s = 0; s < 8; ++s) na[s] = NEG;
    const float hl = 0.5f * lin[t], hp = 0.5f * par[t];
    for (int s = 0; s < 8; ++s) {
      for (int u = 0; u < 2; ++u) {
        const float g = TR.usign[u] * hl + TR.psign[s][u] * hp;
        const int n = TR.ns[s][u];
        na[n] = fmaxf2(na[n], a[s] + g);
      }
    }
    const float z = na[0];
    for (int s = 0; s < 8; ++s) a[s] = na[s] - z;
  }
  // backward + extrinsic
  float b[8], nb[8];
  std::memcpy(b, beta_k, sizeof(b));
  for (int t = k - 1; t >= 0; --t) {
    const float* at = alpha_store + 8 * t;
    const float hl = 0.5f * lin[t], hp = 0.5f * par[t];
    float m0 = NEG, m1 = NEG;
    for (int s = 0; s < 8; ++s) nb[s] = NEG;
    for (int s = 0; s < 8; ++s) {
      for (int u = 0; u < 2; ++u) {
        const float g = TR.usign[u] * hl + TR.psign[s][u] * hp;
        const float bc = g + b[TR.ns[s][u]];
        nb[s] = fmaxf2(nb[s], bc);
        const float m = at[s] + bc;
        if (u == 0) m0 = fmaxf2(m0, m); else m1 = fmaxf2(m1, m);
      }
    }
    ext[t] = (m0 - m1) - lin[t];
    const float z = nb[0];
    for (int s = 0; s < 8; ++s) b[s] = nb[s] - z;
  }
}

}  // namespace

extern "C" {

uint32_t crc_bits(const uint8_t* bits, int32_t n, uint32_t poly,
                  int32_t order);  // srsue_native.cc

// Full turbo decode of one codeblock.
//   d:     [3][k+4] row-major LLRs (positive => bit 0)
//   perm/inv: QPP interleaver + inverse, length k
//   crc_poly/crc_order: early-exit CRC over the whole k bits (0 = none)
// Returns iterations used; hard bits in hard_out[k].
int32_t turbo_decode_maxlog(const float* d, const int32_t* perm,
                            const int32_t* inv, int32_t k, int32_t n_iters,
                            uint32_t crc_poly, int32_t crc_order,
                            uint8_t* hard_out) {
  const float* sys1 = d;
  const float* par1 = d + (k + 4);
  const float* par2 = d + 2 * (k + 4);
  const float* t0 = d + k;          // d0 tails
  const float* t1 = d + (k + 4) + k;
  const float* t2 = d + 2 * (k + 4) + k;
  // tail demultiplex (36.212 §5.1.3.2.2; same as turbo.decode)
  const float tail1_sys[3] = {t0[0], t2[0], t1[1]};
  const float tail1_par[3] = {t1[0], t0[1], t2[1]};
  const float tail2_sys[3] = {t0[2], t2[2], t1[3]};
  const float tail2_par[3] = {t1[2], t0[3], t2[3]};

  float bt1[8], bt2[8];
  tail_beta(tail1_sys, tail1_par, bt1);
  tail_beta(tail2_sys, tail2_par, bt2);

  std::vector<float> sys2(k), lin(k), le12(k), le21(k, 0.0f), ext(k);
  std::vector<float> alpha(8 * (size_t)k);
  for (int i = 0; i < k; ++i) sys2[i] = sys1[perm[i]];

  int it = 0;
  for (; it < n_iters; ++it) {
    for (int i = 0; i < k; ++i) lin[i] = sys1[i] + le21[i];
    bcjr_half(lin.data(), par1, k, bt1, alpha.data(), le12.data());
    for (int i = 0; i < k; ++i) lin[i] = sys2[i] + le12[perm[i]];
    bcjr_half(lin.data(), par2, k, bt2, alpha.data(), ext.data());
    for (int i = 0; i < k; ++i) le21[i] = ext[inv[i]];
    for (int i = 0; i < k; ++i)
      hard_out[i] = (sys1[i] + le12[i] + le21[i]) < 0.0f ? 1 : 0;
    if (crc_order > 0 &&
        crc_bits(hard_out, k, crc_poly, crc_order) == 0) {
      return it + 1;
    }
  }
  return it;
}

// Batched form: n independent codeblocks, d strided by 3*(k+4).
void turbo_decode_maxlog_batch(const float* d, const int32_t* perm,
                               const int32_t* inv, int32_t k, int32_t n,
                               int32_t n_iters, uint32_t crc_poly,
                               int32_t crc_order, uint8_t* hard_out,
                               int32_t* iters_out) {
  const size_t dstride = 3 * (size_t)(k + 4);
  for (int32_t i = 0; i < n; ++i) {
    iters_out[i] = turbo_decode_maxlog(d + i * dstride, perm, inv, k,
                                       n_iters, crc_poly, crc_order,
                                       hard_out + (size_t)i * k);
  }
}

}  // extern "C"
