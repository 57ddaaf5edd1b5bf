// Host runtime of hehub_tpu_torch: this package's own copy of the JAX
// package's csrc/hehub_native.cpp, function for function.
//
// Host-side exact kernels beside the device path (the role of the C++
// reference's CPU-side number theory: bigint/CRT compose bigint.cpp:330-405,
// NTT ntt.cpp:145-222, prime tables primelists.cpp — redesigned, not
// ported: fixed-width 64-bit limb vectors instead of base-10 digit strings,
// Montgomery-free u128 Barrett, programmatic Miller-Rabin primes).
//
// Exposed with a plain C ABI for ctypes. Built with g++ at first use by
// hehub_tpu_torch/native/loader.py; not a GPU kernel.

#include <cstdint>
#include <cstring>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = __uint128_t;

extern "C" {

// ---------------------------------------------------------------------------
// Miller-Rabin (deterministic < 2^64) + NTT prime search
// ---------------------------------------------------------------------------

static u64 mulmod_u64(u64 a, u64 b, u64 m) { return (u128)a * b % m; }

static u64 powmod_u64(u64 a, u64 e, u64 m) {
    u64 r = 1;
    a %= m;
    while (e) {
        if (e & 1) r = mulmod_u64(r, a, m);
        a = mulmod_u64(a, a, m);
        e >>= 1;
    }
    return r;
}

int hh_is_prime_u64(u64 n) {
    if (n < 2) return 0;
    static const u64 bases[] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37};
    for (u64 p : bases) {
        if (n % p == 0) return n == p;
    }
    u64 d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; ++r; }
    for (u64 a : bases) {
        u64 x = powmod_u64(a, d, n);
        if (x == 1 || x == n - 1) continue;
        bool composite = true;
        for (int i = 0; i < r - 1; ++i) {
            x = mulmod_u64(x, x, n);
            if (x == n - 1) { composite = false; break; }
        }
        if (composite) return 0;
    }
    return 1;
}

// Signed-int64 residue decomposition: coeffs [count] i64 -> residues
// [L, count] u32 (strict). The hot half of the CKKS encoder's host work.
void hh_decompose_i64(const int64_t* coeffs, long long count,
                      const u64* mods, int L, u32* out) {
    for (int l = 0; l < L; ++l) {
        const int64_t q = (int64_t)mods[l];
        u32* row = out + (size_t)l * count;
        for (long long i = 0; i < count; ++i) {
            int64_t r = coeffs[i] % q;
            if (r < 0) r += q;
            row[i] = (u32)r;
        }
    }
}

// Find `count` NTT primes q ≡ 1 (mod 2n), 2^(bits-1) <= q < 2^bits, searching
// downward. Returns number found.
int hh_gen_ntt_primes(int bits, int count, u64 n, u64* out) {
    u64 step = 2 * n;
    u64 hi = (u64)1 << bits;
    u64 lo = (u64)1 << (bits - 1);
    u64 q = hi - ((hi - 1) % step);
    int found = 0;
    while (found < count && q > lo) {
        if (hh_is_prime_u64(q)) out[found++] = q;
        q -= step;
    }
    return found;
}

// ---------------------------------------------------------------------------
// Exact CRT compose: residues [L, n] u32 -> centered values as i64 when they
// fit, else flagged. Limb-vector big integers for the general path.
// ---------------------------------------------------------------------------

namespace {

// little multiprecision helpers over vector<u64> (little-endian limbs)
static void mp_mul_small(std::vector<u64>& a, u64 m) {
    u128 carry = 0;
    for (auto& x : a) {
        u128 t = (u128)x * m + carry;
        x = (u64)t;
        carry = t >> 64;
    }
    if (carry) a.push_back((u64)carry);
}

static void mp_add_small(std::vector<u64>& a, u64 v) {
    u128 carry = v;
    for (auto& x : a) {
        if (!carry) break;
        u128 t = (u128)x + carry;
        x = (u64)t;
        carry = t >> 64;
    }
    if (carry) a.push_back((u64)carry);
}

static void mp_add(std::vector<u64>& a, const std::vector<u64>& b) {
    if (b.size() > a.size()) a.resize(b.size(), 0);
    u128 carry = 0;
    for (size_t i = 0; i < a.size(); ++i) {
        u128 t = (u128)a[i] + (i < b.size() ? b[i] : 0) + carry;
        a[i] = (u64)t;
        carry = t >> 64;
    }
    if (carry) a.push_back((u64)carry);
}

static int mp_cmp(const std::vector<u64>& a, const std::vector<u64>& b) {
    size_t na = a.size(), nb = b.size();
    while (na && a[na - 1] == 0) --na;
    while (nb && b[nb - 1] == 0) --nb;
    if (na != nb) return na < nb ? -1 : 1;
    for (size_t i = na; i-- > 0;) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

static void mp_sub(std::vector<u64>& a, const std::vector<u64>& b) {  // a >= b
    long long borrow = 0;
    for (size_t i = 0; i < a.size(); ++i) {
        u128 bi = (i < b.size() ? b[i] : 0);
        u128 ai = a[i];
        u128 rhs = bi + (borrow ? 1 : 0);
        if (ai >= rhs) {
            a[i] = (u64)(ai - rhs);
            borrow = 0;
        } else {
            a[i] = (u64)(((u128)1 << 64) + ai - rhs);
            borrow = 1;
        }
    }
}

static u64 mp_mod_u64(const std::vector<u64>& a, u64 m) {
    u128 r = 0;
    for (size_t i = a.size(); i-- > 0;) {
        r = ((r << 32) | (a[i] >> 32)) % m;
        r = ((r << 32) | (a[i] & 0xffffffffULL)) % m;
    }
    return (u64)r;
}

}  // namespace

// CRT-compose residues[k*n + i] (mod moduli[k]) for each coefficient i, then
// reduce the *centered* value mod new_mod into out[i] (in [0, new_mod)).
// This is the exact k->1 signed base conversion used by BGV decryption
// (role of rns_base_transform_to_single, rns_transform.cpp:39-105).
void hh_compose_mod(const u32* residues, const u64* moduli, int L, long long n,
                    u64 new_mod, u32* out) {
    // Garner precompute: punctured products P_k = Q/q_k mod-free via bigints
    std::vector<std::vector<u64>> punctured(L);
    std::vector<u64> Q{1};
    for (int k = 0; k < L; ++k) mp_mul_small(Q, moduli[k]);
    for (int k = 0; k < L; ++k) {
        std::vector<u64> p{1};
        for (int j = 0; j < L; ++j)
            if (j != k) mp_mul_small(p, moduli[j]);
        punctured[k] = std::move(p);
    }
    std::vector<u64> inv(L);
    for (int k = 0; k < L; ++k) {
        u64 pk = mp_mod_u64(punctured[k], moduli[k]);
        inv[k] = powmod_u64(pk, moduli[k] - 2, moduli[k]);  // prime moduli
    }
    std::vector<u64> half_Q = Q;  // floor(Q/2)
    {
        u64 carry = 0;
        for (size_t i = half_Q.size(); i-- > 0;) {
            u64 cur = half_Q[i];
            half_Q[i] = (cur >> 1) | (carry << 63);
            carry = cur & 1;
        }
    }
    u64 q_mod_new = mp_mod_u64(Q, new_mod);

    std::vector<u64> acc;
    for (long long i = 0; i < n; ++i) {
        acc.assign(1, 0);
        for (int k = 0; k < L; ++k) {
            u64 yk = mulmod_u64(residues[(size_t)k * n + i] % moduli[k], inv[k],
                                moduli[k]);
            std::vector<u64> term = punctured[k];
            mp_mul_small(term, yk);
            mp_add(acc, term);
        }
        // acc mod Q (acc < L*Q, subtract Q a few times)
        while (mp_cmp(acc, Q) >= 0) mp_sub(acc, Q);
        u64 r = mp_mod_u64(acc, new_mod);
        if (mp_cmp(acc, half_Q) > 0) {
            // negative representative: value - Q
            r = (r + new_mod - q_mod_new % new_mod) % new_mod;
        }
        out[i] = (u32)r;
    }
}

// Centered CRT compose to double (for CKKS decode): out[i] = double of the
// centered composed value.
void hh_compose_double(const u32* residues, const u64* moduli, int L,
                       long long n, double* out) {
    std::vector<std::vector<u64>> punctured(L);
    std::vector<u64> Q{1};
    for (int k = 0; k < L; ++k) mp_mul_small(Q, moduli[k]);
    for (int k = 0; k < L; ++k) {
        std::vector<u64> p{1};
        for (int j = 0; j < L; ++j)
            if (j != k) mp_mul_small(p, moduli[j]);
        punctured[k] = std::move(p);
    }
    std::vector<u64> inv(L);
    for (int k = 0; k < L; ++k) {
        u64 pk = mp_mod_u64(punctured[k], moduli[k]);
        inv[k] = powmod_u64(pk, moduli[k] - 2, moduli[k]);
    }
    std::vector<u64> half_Q = Q;
    {
        u64 carry = 0;
        for (size_t i = half_Q.size(); i-- > 0;) {
            u64 cur = half_Q[i];
            half_Q[i] = (cur >> 1) | (carry << 63);
            carry = cur & 1;
        }
    }
    auto to_double = [](const std::vector<u64>& a) {
        double r = 0, scale = 1;
        for (size_t i = 0; i < a.size(); ++i) {
            r += (double)a[i] * scale;
            scale *= 18446744073709551616.0;  // 2^64
        }
        return r;
    };
    std::vector<u64> acc;
    for (long long i = 0; i < n; ++i) {
        acc.assign(1, 0);
        for (int k = 0; k < L; ++k) {
            u64 yk = mulmod_u64(residues[(size_t)k * n + i] % moduli[k], inv[k],
                                moduli[k]);
            std::vector<u64> term = punctured[k];
            mp_mul_small(term, yk);
            mp_add(acc, term);
        }
        while (mp_cmp(acc, Q) >= 0) mp_sub(acc, Q);
        if (mp_cmp(acc, half_Q) > 0) {
            std::vector<u64> neg = Q;
            mp_sub(neg, acc);
            out[i] = -to_double(neg);
        } else {
            out[i] = to_double(acc);
        }
    }
}

// ---------------------------------------------------------------------------
// Fused single-pass halves of the CKKS host encode/decode pipeline. These
// replace multi-pass numpy chains (rint -> abs -> max -> int64 -> 3x
// shift/mask, and the K-row balanced-carry loop): the host side of
// simd_encode/simd_decode (ckks/basics.cpp:156-366) costs one memory pass
// here instead of ~12 numpy passes.
// ---------------------------------------------------------------------------

// Base-2^22 digit split of rint(coeffs): float64 [rows, n] ->
// digits u32 [rows, 3, n] + neg u32 [rows, n]. Returns 1 if any
// |rint(x)| >= 2^62 (caller raises), else 0. llrint under the default
// FE_TONEAREST mode matches np.rint (round-half-to-even) exactly.
int hh_digitize(const double* coeffs, long long rows, long long n,
                u32* digits, u32* neg) {
    const double lim = 4611686018427387904.0;  // 2^62
    int overflow = 0;
    for (long long r = 0; r < rows; ++r) {
        const double* src = coeffs + r * n;
        u32* d0 = digits + (size_t)r * 3 * n;
        u32* d1 = d0 + n;
        u32* d2 = d1 + n;
        u32* ng = neg + r * n;
        for (long long i = 0; i < n; ++i) {
            double x = __builtin_nearbyint(src[i]);
            if (x >= lim || x <= -lim) overflow = 1;
            int64_t ix = (int64_t)x;
            ng[i] = (u32)(ix < 0);
            u64 ax = (u64)(ix < 0 ? -ix : ix);
            d0[i] = (u32)(ax & 0x3fffffULL);
            d1[i] = (u32)((ax >> 22) & 0x3fffffULL);
            d2[i] = (u32)((ax >> 44) & 0x3fffffULL);
        }
    }
    return overflow;
}

// Encode pre-FFT: out[r,i] = data[r, invj[i]], conjugated when invj[i] is
// odd (slot order -> DFT bin order with the odd-slot conjugation folded).
// data/out are interleaved complex double [rows, half].
void hh_encode_pre(const double* data, const int64_t* invj, long long rows,
                   long long half, double* out) {
    for (long long r = 0; r < rows; ++r) {
        const double* src = data + r * 2 * half;
        double* dst = out + r * 2 * half;
        for (long long i = 0; i < half; ++i) {
            int64_t s = invj[i];
            dst[2 * i] = src[2 * s];
            dst[2 * i + 1] = (s & 1) ? -src[2 * s + 1] : src[2 * s + 1];
        }
    }
}

// Encode post-FFT: twist + scale + rint + base-2^22 digit split in ONE pass.
// u = FFT output (interleaved complex [rows, half]), tw = tw_enc
// (interleaved complex [half]); coefficient i gets re((u*tw)[i])*scale,
// coefficient half+i gets im((u*tw)[i])*scale. Emits digits
// [rows, 3, 2*half] + neg [rows, 2*half]; returns 1 on |coeff| >= 2^62.
int hh_encode_post(const double* u, const double* tw, double scale,
                   long long rows, long long half, u32* digits, u32* neg) {
    const double lim = 4611686018427387904.0;  // 2^62
    const long long n = 2 * half;
    int overflow = 0;
    for (long long r = 0; r < rows; ++r) {
        const double* src = u + r * 2 * half;
        u32* d0 = digits + (size_t)r * 3 * n;
        u32* d1 = d0 + n;
        u32* d2 = d1 + n;
        u32* ng = neg + r * n;
        for (long long i = 0; i < half; ++i) {
            double a = src[2 * i], b = src[2 * i + 1];
            double c = tw[2 * i], d = tw[2 * i + 1];
            double re = (a * c - b * d) * scale;
            double im = (a * d + b * c) * scale;
            for (int part = 0; part < 2; ++part) {
                double x = __builtin_nearbyint(part ? im : re);
                if (x >= lim || x <= -lim) overflow = 1;
                int64_t ix = (int64_t)x;
                long long k = part ? half + i : i;
                ng[k] = (u32)(ix < 0);
                u64 ax = (u64)(ix < 0 ? -ix : ix);
                d0[k] = (u32)(ax & 0x3fffffULL);
                d1[k] = (u32)((ax >> 22) & 0x3fffffULL);
                d2[k] = (u32)((ax >> 44) & 0x3fffffULL);
            }
        }
    }
    return overflow;
}

// Decode pre-iFFT: u[r,i] = ((c[r,i] + i*c[r,half+i]) / scale) * tw[i] —
// the complex build, the 1/scale normalization, and the twist in one pass.
void hh_decode_pre(const double* coeffs, const double* tw, double scale,
                   long long rows, long long half, double* out) {
    for (long long r = 0; r < rows; ++r) {
        const double* src = coeffs + r * 2 * half;
        double* dst = out + r * 2 * half;
        for (long long i = 0; i < half; ++i) {
            double a = src[i] / scale, b = src[half + i] / scale;
            double c = tw[2 * i], d = tw[2 * i + 1];
            dst[2 * i] = a * c - b * d;
            dst[2 * i + 1] = a * d + b * c;
        }
    }
}

// Decode post-iFFT: out[r,i] = vals[r, j[i]], conjugated at odd output
// positions (DFT bin order -> slot order). Interleaved complex doubles.
void hh_decode_post(const double* vals, const int64_t* j, long long rows,
                    long long half, long long count, double* out) {
    for (long long r = 0; r < rows; ++r) {
        const double* src = vals + r * 2 * half;
        double* dst = out + r * 2 * count;
        for (long long i = 0; i < count; ++i) {
            int64_t s = j[i];
            dst[2 * i] = src[2 * s];
            dst[2 * i + 1] = (i & 1) ? -src[2 * s + 1] : src[2 * s + 1];
        }
    }
}

// Balanced-digit carry pass over Garner mixed-radix digits
// [rows, K, n] u32 -> centered float64 values [rows, n]:
//   dj = d[j] + carry; carry = dj > q_j/2; bal = dj - carry*q_j;
//   out = sum bal_j * prod_{m<j} q_m    (final carry out of the top digit
// is the mod-prod(q) wrap and is dropped — same as the numpy path).
// split_top != 0: the last digit row is an overflow sentinel — excluded
// from the value; its balanced digits are written to top [rows, n] i64 and
// top_nonzero reports whether ANY of them is nonzero.
void hh_mixed_radix(const u32* digits, long long rows, int K, long long n,
                    const u64* mods, int split_top, double* out,
                    int64_t* top, int* top_nonzero) {
    int any_top = 0;
    std::vector<int64_t> carry(n);
    for (long long r = 0; r < rows; ++r) {
        const u32* base = digits + (size_t)r * K * n;
        double* dst = out + r * n;
        std::memset(carry.data(), 0, n * sizeof(int64_t));
        double weight = 1.0;
        for (int j = 0; j < K; ++j) {
            const int64_t q = (int64_t)mods[j];
            const int64_t hq = q >> 1;
            const u32* row = base + (size_t)j * n;
            const bool is_sentinel = split_top && j == K - 1;
            if (is_sentinel && j == 0) std::memset(dst, 0, n * sizeof(double));
            if (j == 0 && !is_sentinel) {
                // first row: no incoming carry, dst = bal (initializes out)
                for (long long i = 0; i < n; ++i) {
                    int64_t dj = (int64_t)row[i];
                    int64_t c = dj > hq;
                    carry[i] = c;
                    dst[i] = (double)(dj - (c ? q : 0));
                }
            } else if (is_sentinel) {
                int64_t* tp = top + r * n;
                int64_t nz = 0;
                for (long long i = 0; i < n; ++i) {
                    int64_t dj = (int64_t)row[i] + carry[i];
                    int64_t bal = dj - (dj > hq ? q : 0);
                    tp[i] = bal;
                    nz |= bal;
                }
                if (nz) any_top = 1;
            } else {
                for (long long i = 0; i < n; ++i) {
                    int64_t dj = (int64_t)row[i] + carry[i];
                    int64_t c = dj > hq;
                    carry[i] = c;
                    dst[i] += (double)(dj - (c ? q : 0)) * weight;
                }
            }
            if (!is_sentinel) weight *= (double)q;
        }
        if (K == 0) std::memset(dst, 0, n * sizeof(double));
    }
    if (top_nonzero) *top_nonzero = split_top ? any_top : 0;
}

// ---------------------------------------------------------------------------
// Host negacyclic NTT (oracle / keygen helper); same no-bitreversal layout as
// the device kernels: CT forward natural->bitrev, Shoup-free u128 mulmod.
// ---------------------------------------------------------------------------

void hh_ntt_fwd(u32* data, long long n, u64 q, const u32* tw /* psi^bitrev */) {
    for (long long m = 1, t = n >> 1; m < n; m <<= 1, t >>= 1) {
        for (long long b = 0; b < m; ++b) {
            u64 w = tw[m + b];
            u32* lo = data + 2 * b * t;
            u32* hi = lo + t;
            for (long long j = 0; j < t; ++j) {
                u64 wh = mulmod_u64(hi[j], w, q);
                u64 l = lo[j] % q;
                hi[j] = (u32)((l + q - wh) % q);
                lo[j] = (u32)((l + wh) % q);
            }
        }
    }
}

void hh_ntt_inv(u32* data, long long n, u64 q, const u32* tw_inv, u64 n_inv) {
    for (long long t = 1, h = n >> 1; h >= 1; t <<= 1, h >>= 1) {
        for (long long b = 0; b < h; ++b) {
            u64 w = tw_inv[h + b];
            u32* lo = data + 2 * b * t;
            u32* hi = lo + t;
            for (long long j = 0; j < t; ++j) {
                u64 l = lo[j] % q, hgh = hi[j] % q;
                lo[j] = (u32)((l + hgh) % q);
                hi[j] = (u32)mulmod_u64((l + q - hgh) % q, w, q);
            }
        }
    }
    for (long long i = 0; i < n; ++i)
        data[i] = (u32)mulmod_u64(data[i], n_inv, q);
}

}  // extern "C"
