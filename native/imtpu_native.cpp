// Native host-side runtime for image_matching.
//
// The reference implements its whole runtime in C++ (dataset loading in
// src/main.cpp:216-230, big-integer arithmetic inside OpenFHE).  Our device
// compute path is JAX/XLA; this library covers the host-side pieces where
// Python is the wrong tool:
//
//   * imtpu_parse_dat: fast whitespace-separated integer parsing for the
//     .dat datasets (a 2^20 x 512 dataset is ~5e8 tokens — minutes in
//     Python, seconds here).
//   * imtpu_crt_compose_centered: exact CRT reconstruction of centered
//     coefficients from RNS residues with an arbitrary number of 31-bit
//     limbs — the exact decode path behind decryption.
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 in the
// image); build with `make -C native`.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse up to `max_vals` whitespace-separated numbers from a text file
// into out[]; returns the count parsed, or -1 on IO error.
long imtpu_parse_dat(const char* path, double* out, long max_vals) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -1;
    }
    fclose(f);
    buf[size] = '\0';
    long n = 0;
    const char* p = buf.data();
    const char* end = p + size;
    while (p < end && n < max_vals) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
            ++p;
        if (p >= end) break;
        char* next;
        double v = strtod(p, &next);
        if (next == p) break;
        out[n++] = v;
        p = next;
    }
    return n;
}

namespace {

// Minimal little-endian multi-word unsigned integer helpers (32-bit words).
using words = std::vector<uint32_t>;

void add_mul_small(words& acc, const words& m, uint32_t c) {
    // acc += m * c
    if (acc.size() < m.size() + 1) acc.resize(m.size() + 1, 0);
    uint64_t carry = 0;
    size_t i = 0;
    for (; i < m.size(); ++i) {
        uint64_t t = (uint64_t)m[i] * c + acc[i] + carry;
        acc[i] = (uint32_t)t;
        carry = t >> 32;
    }
    for (; carry && i < acc.size(); ++i) {
        uint64_t t = (uint64_t)acc[i] + carry;
        acc[i] = (uint32_t)t;
        carry = t >> 32;
    }
    if (carry) acc.push_back((uint32_t)carry);
}

void mul_small(words& a, uint32_t c) {
    uint64_t carry = 0;
    for (size_t i = 0; i < a.size(); ++i) {
        uint64_t t = (uint64_t)a[i] * c + carry;
        a[i] = (uint32_t)t;
        carry = t >> 32;
    }
    if (carry) a.push_back((uint32_t)carry);
}

int cmp(const words& a, const words& b) {
    size_t la = a.size(), lb = b.size();
    while (la && a[la - 1] == 0) --la;
    while (lb && b[lb - 1] == 0) --lb;
    if (la != lb) return la < lb ? -1 : 1;
    for (size_t i = la; i-- > 0;) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

void sub_from(words& a, const words& b) {
    // a = a - b (requires a >= b)
    int64_t borrow = 0;
    for (size_t i = 0; i < a.size(); ++i) {
        int64_t t = (int64_t)a[i] - (i < b.size() ? b[i] : 0) - borrow;
        borrow = t < 0;
        a[i] = (uint32_t)(t + (borrow << 32));
    }
}

double to_double(const words& a, bool neg) {
    double v = 0;
    for (size_t i = a.size(); i-- > 0;) v = v * 4294967296.0 + a[i];
    return neg ? -v : v;
}

uint64_t mod_u64(const words& a, uint64_t q) {
    uint64_t r = 0;
    for (size_t i = a.size(); i-- > 0;) r = ((r << 32) | a[i]) % q;
    return r;
}

uint64_t inv_mod(uint64_t a, uint64_t m) {
    int64_t t = 0, nt = 1;
    int64_t r = (int64_t)m, nr = (int64_t)(a % m);
    while (nr) {
        int64_t qq = r / nr;
        int64_t tmp = t - qq * nt; t = nt; nt = tmp;
        tmp = r - qq * nr; r = nr; nr = tmp;
    }
    return (uint64_t)(t < 0 ? t + (int64_t)m : t);
}

}  // namespace

// res: uint32[L * n] standard-form residues (limb-major), primes: uint64[L].
// out: double[n] centered exact CRT values (as float64).
void imtpu_crt_compose_centered(const uint32_t* res, long L, long n,
                                const uint64_t* primes, double* out) {
    // Q and M_i = Qhat_i * (Qhat_i^{-1} mod q_i)
    words Q{1};
    for (long i = 0; i < L; ++i) mul_small(Q, (uint32_t)primes[i]);
    std::vector<words> M(L);
    for (long i = 0; i < L; ++i) {
        words Qi{1};
        for (long j = 0; j < L; ++j)
            if (j != i) mul_small(Qi, (uint32_t)primes[j]);
        uint64_t qi = primes[i];
        uint64_t inv = inv_mod(mod_u64(Qi, qi), qi);
        mul_small(Qi, (uint32_t)inv);  // inv < q_i < 2^31 fits a word
        M[i] = Qi;
    }
    words half = Q;  // Q/2
    {
        uint32_t carry = 0;
        for (size_t i = half.size(); i-- > 0;) {
            uint32_t cur = half[i];
            half[i] = (cur >> 1) | (carry << 31);
            carry = cur & 1;
        }
    }
    words acc;
    for (long k = 0; k < n; ++k) {
        acc.assign(Q.size() + 2, 0);
        for (long i = 0; i < L; ++i)
            add_mul_small(acc, M[i], res[i * n + k]);
        // acc mod Q via repeated shifted subtraction (acc < L * Q * 2^31,
        // so at most ~32+log2(L) subtraction rounds)
        words shifted = Q;
        int shifts = 0;
        while (cmp(shifted, acc) <= 0) {
            mul_small(shifted, 2);
            ++shifts;
        }
        for (int s = 0; s <= shifts; ++s) {
            // halve shifted once per round (first round: too big, skip sub)
            if (s > 0) {
                uint32_t carry = 0;
                for (size_t i = shifted.size(); i-- > 0;) {
                    uint32_t cur = shifted[i];
                    shifted[i] = (cur >> 1) | (carry << 31);
                    carry = cur & 1;
                }
            }
            if (cmp(shifted, acc) <= 0 && s > 0) sub_from(acc, shifted);
        }
        // center
        if (cmp(acc, half) > 0) {
            words t = Q;
            sub_from(t, acc);
            out[k] = to_double(t, true);
        } else {
            out[k] = to_double(acc, false);
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host enrollment engine: seed-compressed (c1-from-seed) symmetric CKKS
// encryption of DB ciphertext batches entirely on the host — the bulk
// counterpart of the reference's OpenMP encrypt-and-serialize enrollment
// (reference src/enroller/*.cpp).  It builds the enrolled c0 store in host
// RAM with no device at all (offline enrollment, tools/enroll_cache.py);
// the device regenerates c1 from the same Threefry-2x32-20 stream
// (image_matching/ops/prng.py).
// ---------------------------------------------------------------------------

#include <thread>

namespace {

static inline uint32_t mont_mul32(uint32_t a, uint32_t b, uint32_t q,
                                  uint32_t qneg) {
    uint64_t T = (uint64_t)a * b;
    uint32_t m = (uint32_t)T * qneg;
    uint64_t t = (T + (uint64_t)m * q) >> 32;
    uint32_t r = (uint32_t)t;
    return r >= q ? r - q : r;
}

// Shoup multiply by a constant w with precomputed w_sh = floor(w*2^32/q).
static inline uint32_t shoup_mul32(uint32_t a, uint32_t w, uint32_t w_sh,
                                   uint32_t q) {
    uint32_t hi = (uint32_t)(((uint64_t)a * w_sh) >> 32);
    uint32_t r = a * w - hi * q;  // wraps mod 2^32; result in [0, 2q)
    return r >= q ? r - q : r;
}

// Threefry-2x32-20 (matches ops/prng.py threefry2x32 exactly).
static inline void tf2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                          uint32_t* y0, uint32_t* y1) {
    static const int ROT[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t ks[3] = {ks1, ks2, ks0};
    x0 += ks0;
    x1 += ks1;
    for (int i = 0; i < 5; ++i) {
        int base = (4 * i) % 8;
        for (int j = 0; j < 4; ++j) {
            int r = ROT[base + j];
            x0 += x1;
            x1 = (x1 << r) | (x1 >> (32 - r));
            x1 ^= x0;
        }
        x0 += ks[i % 3];
        x1 += ks[(i + 1) % 3] + (uint32_t)(i + 1);
    }
    *y0 = x0;
    *y1 = x1;
}

// Forward negacyclic NTT, standard form, same wiring as
// image_matching/ops/ntt.py host_ntt_fwd (merged-twiddle CT,
// natural order in, bit-reversed eval order out).
static void ntt_fwd32(uint32_t* a, long n, uint32_t q, const uint32_t* psis,
                      const uint32_t* psis_sh) {
    for (long m = 1; m < n; m <<= 1) {
        long t = n / (2 * m);
        for (long g = 0; g < m; ++g) {
            uint32_t w = psis[m + g];
            uint32_t w_sh = psis_sh[m + g];
            uint32_t* u = a + g * 2 * t;
            uint32_t* v = u + t;
            for (long k = 0; k < t; ++k) {
                uint32_t vv = shoup_mul32(v[k], w, w_sh, q);
                uint32_t uu = u[k];
                uint32_t s = uu + vv;
                u[k] = s >= q ? s - q : s;
                v[k] = uu >= vv ? uu - vv : uu + (q - vv);
            }
        }
    }
}

struct LimbConsts {
    uint32_t q, qneg, r2;
    std::vector<uint32_t> psis_sh;
};

}  // namespace

extern "C" {

// Enroll one DB ciphertext group on the host:
//   m_plus_e: [B, N] natural-order signed coefficients (message + noise)
//   psis:     [L, N] standard-form forward twiddle tables (NttPlan.psis_np)
//   s_eval:   [L, N] standard-form eval-domain secret key
//   c0_out:   [B, L, N] <- Montgomery/eval-form c0 with
//             c0 = NTT(m+e) - c1*s, c1[b,l,k] = threefry(seed, group;
//             idx=(b*L+l)*N+k) reduced mod q_l (Montgomery by convention).
void imtpu_enroll_group(const int64_t* m_plus_e, long B, long N, long L,
                        const uint32_t* primes, const uint32_t* psis,
                        const uint32_t* s_eval, uint32_t seed, uint32_t group,
                        uint32_t* c0_out, int n_threads) {
    std::vector<LimbConsts> lc(L);
    for (long l = 0; l < L; ++l) {
        uint32_t q = primes[l];
        // -q^{-1} mod 2^32 by Newton iteration
        uint32_t inv = q;  // q odd
        for (int it = 0; it < 5; ++it) inv *= 2u - q * inv;
        lc[l].q = q;
        lc[l].qneg = (uint32_t)(0u - inv);
        lc[l].r2 = (uint32_t)((((unsigned __int128)1) << 64) % q);
        lc[l].psis_sh.resize(N);
        for (long k = 0; k < N; ++k)
            lc[l].psis_sh[k] =
                (uint32_t)((((uint64_t)psis[l * N + k]) << 32) / q);
    }
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](long b0, long b1) {
        std::vector<uint32_t> buf(N);
        for (long b = b0; b < b1; ++b) {
            for (long l = 0; l < L; ++l) {
                const LimbConsts& c = lc[l];
                uint32_t q = c.q;
                const uint32_t* sp = s_eval + l * N;
                uint32_t* out = c0_out + (b * L + l) * N;
                for (long k = 0; k < N; ++k) {
                    int64_t m = m_plus_e[b * N + k] % (int64_t)q;
                    buf[k] = (uint32_t)(m < 0 ? m + q : m);
                }
                ntt_fwd32(buf.data(), N, q, psis + l * N, c.psis_sh.data());
                uint64_t idx0 = ((uint64_t)b * L + l) * N;
                for (long k = 0; k < N; ++k) {
                    uint32_t hi, lo;
                    tf2x32(seed, group, (uint32_t)(idx0 + k), 0, &hi, &lo);
                    uint64_t v = ((uint64_t)hi << 32) | lo;
                    uint32_t c1 = (uint32_t)(v % q);  // Montgomery by decl
                    // standard-form c1*s = mont_mul(c1_mont, s_std)
                    uint32_t c1s = mont_mul32(c1, sp[k], q, c.qneg);
                    uint32_t m_ev = buf[k];
                    uint32_t c0 =
                        m_ev >= c1s ? m_ev - c1s : m_ev + (q - c1s);
                    // to Montgomery form
                    out[k] = mont_mul32(c0, c.r2, q, c.qneg);
                }
            }
        }
    };
    if (n_threads == 1 || B == 1) {
        worker(0, B);
        return;
    }
    std::vector<std::thread> ths;
    long per = (B + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        long b0 = t * per, b1 = b0 + per > B ? B : b0 + per;
        if (b0 < b1) ths.emplace_back(worker, b0, b1);
    }
    for (auto& th : ths) th.join();
}

}  // extern "C"
