// Native host-side hot paths — the C++ runtime components the reference
// keeps in C (SURVEY.md §2.4/§2.6): bit-serial codecs and sequence
// generators that are branchy/bit-oriented and therefore poor fits for
// the device compute path but hot on the host side (eNB-side test-vector
// generation, per-TTI scrambling pregen, control-plane CRCs).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC -o libsrsue_native.so srsue_native.cc

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// 36.211 §7.2 Gold sequence
// ---------------------------------------------------------------------------
void gold_sequence(uint32_t c_init, int32_t length, uint8_t* out) {
    const int NC = 1600;
    // state registers as 31-bit ints, bit i = x(n+i)
    uint32_t x1 = 1;            // x1(0)=1, rest 0
    uint32_t x2 = c_init & 0x7FFFFFFFu;
    // advance both by NC using the per-step recurrences
    for (int n = 0; n < NC; ++n) {
        uint32_t n1 = ((x1 >> 3) ^ x1) & 1u;
        uint32_t n2 = ((x2 >> 3) ^ (x2 >> 2) ^ (x2 >> 1) ^ x2) & 1u;
        x1 = (x1 >> 1) | (n1 << 30);
        x2 = (x2 >> 1) | (n2 << 30);
    }
    for (int n = 0; n < length; ++n) {
        out[n] = (uint8_t)((x1 ^ x2) & 1u);
        uint32_t n1 = ((x1 >> 3) ^ x1) & 1u;
        uint32_t n2 = ((x2 >> 3) ^ (x2 >> 2) ^ (x2 >> 1) ^ x2) & 1u;
        x1 = (x1 >> 1) | (n1 << 30);
        x2 = (x2 >> 1) | (n2 << 30);
    }
}

// ---------------------------------------------------------------------------
// 36.212 §5.1.3.2 turbo encoder (rate 1/3 PCCC, g0=13, g1=15 octal)
// d_out layout: 3 streams of (k+4): d0 | d1 | d2 (row-major [3, k+4])
// perm: QPP interleaver table pi(i), length k (precomputed by caller)
// ---------------------------------------------------------------------------
static inline void rsc_encode(const uint8_t* b, int32_t k, uint8_t* parity,
                              uint8_t* tail_sys, uint8_t* tail_par) {
    unsigned s = 0;  // 3-bit state (r1 r2 r3)
    for (int i = 0; i < k; ++i) {
        unsigned r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
        unsigned u = b[i];
        unsigned a = u ^ r2 ^ r3;          // feedback-cancelled input
        parity[i] = (uint8_t)(a ^ r1 ^ r3);  // g1 = 1 + D + D^3
        s = (a << 2) | (r1 << 1) | r2;
    }
    for (int i = 0; i < 3; ++i) {
        unsigned r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
        unsigned u = r2 ^ r3;              // termination input
        unsigned a = u ^ r2 ^ r3;          // == 0
        tail_sys[i] = (uint8_t)u;
        tail_par[i] = (uint8_t)(a ^ r1 ^ r3);
        s = (a << 2) | (r1 << 1) | r2;
    }
}

void turbo_encode(const uint8_t* bits, const int32_t* perm, int32_t k,
                  uint8_t* d_out) {
    uint8_t* d0 = d_out;
    uint8_t* d1 = d_out + (k + 4);
    uint8_t* d2 = d_out + 2 * (k + 4);

    static thread_local uint8_t interleaved[8192];
    uint8_t t1x[3], t1z[3], t2x[3], t2z[3];

    for (int i = 0; i < k; ++i) interleaved[i] = bits[perm[i]];
    rsc_encode(bits, k, d1, t1x, t1z);
    rsc_encode(interleaved, k, d2, t2x, t2z);
    std::memcpy(d0, bits, k);
    // tail multiplexing (36.212 §5.1.3.2.2)
    d0[k + 0] = t1x[0]; d1[k + 0] = t1z[0]; d2[k + 0] = t1x[1];
    d0[k + 1] = t1z[1]; d1[k + 1] = t1x[2]; d2[k + 1] = t1z[2];
    d0[k + 2] = t2x[0]; d1[k + 2] = t2z[0]; d2[k + 2] = t2x[1];
    d0[k + 3] = t2z[1]; d1[k + 3] = t2x[2]; d2[k + 3] = t2z[2];
}

// ---------------------------------------------------------------------------
// 36.212 §5.1.3.1 tail-biting convolutional encoder (K=7, 133/171/165)
// out: [3, n] row-major
// ---------------------------------------------------------------------------
void conv_encode(const uint8_t* bits, int32_t n, uint8_t* out) {
    const unsigned G[3] = {0x5B, 0x79, 0x75};  // octal 133,171,165 as 7-bit
    unsigned s = 0;
    for (int i = 0; i < 6; ++i) s |= (unsigned)(bits[n - 1 - i] & 1) << (5 - i);
    for (int i = 0; i < n; ++i) {
        unsigned w = ((unsigned)(bits[i] & 1) << 6) | s;
        for (int j = 0; j < 3; ++j)
            out[j * n + i] = (uint8_t)(__builtin_popcount(w & G[j]) & 1);
        s = w >> 1;
    }
}

// ---------------------------------------------------------------------------
// CRC (MSB-first, zero init) — generic up to 32-bit polys
// ---------------------------------------------------------------------------
uint32_t crc_bits(const uint8_t* bits, int32_t n, uint32_t poly, int32_t order) {
    uint32_t r = 0;
    uint32_t top = 1u << (order - 1);
    uint32_t mask = (order == 32) ? 0xFFFFFFFFu : ((1u << order) - 1);
    for (int i = 0; i < n; ++i) {
        uint32_t in = bits[i] & 1u;
        uint32_t fb = ((r & top) ? 1u : 0u) ^ in;
        r = (r << 1) & mask;
        if (fb) r ^= poly;
    }
    return r;
}

}  // extern "C"
