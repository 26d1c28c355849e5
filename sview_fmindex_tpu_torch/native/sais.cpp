// Linear-time suffix-array construction (SA-IS, induced sorting).
//
// Native backend for sview_fmindex_tpu_torch — the role the optional libdivsufsort
// FFI plays in the reference crate (fastbwt feature,
// reference: sview-fmindex/src/components/suffix_array/burrow_wheeler_transform/
// libdivsufsort/mod.rs).  Clean-room implementation of the classic SA-IS
// algorithm (Nong, Zhang & Chan 2009).
//
// Input contract (matches the reference's sentinel convention,
// crate_bio_manual/mod.rs:8-23): the text ends with a unique, smallest
// symbol (the 0 sentinel appended by the caller).
//
// Index type is templated: int32 for n < 2^31 (halves memory: ~5n bytes
// total), int64 beyond.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename C, typename I>
void get_buckets(const C* s, I* bkt, I n, I K, bool end) {
    for (I i = 0; i <= K; ++i) bkt[i] = 0;
    for (I i = 0; i < n; ++i) bkt[(I)s[i]]++;
    I sum = 0;
    for (I i = 0; i <= K; ++i) {
        sum += bkt[i];
        bkt[i] = end ? sum : sum - bkt[i];
    }
}

template <typename C, typename I>
void induce_l(const C* s, I* sa, const uint8_t* t, I* bkt, I n, I K) {
    get_buckets<C, I>(s, bkt, n, K, false);
    for (I i = 0; i < n; ++i) {
        I j = sa[i] - 1;
        if (sa[i] > 0 && !t[(size_t)j]) sa[bkt[(I)s[j]]++] = j;
    }
}

template <typename C, typename I>
void induce_s(const C* s, I* sa, const uint8_t* t, I* bkt, I n, I K) {
    get_buckets<C, I>(s, bkt, n, K, true);
    for (I i = n - 1; i >= 0; --i) {
        I j = sa[i] - 1;
        if (sa[i] > 0 && t[(size_t)j]) sa[--bkt[(I)s[j]]] = j;
    }
}

// s: length n, values in [0, K], s[n-1] unique smallest.
template <typename C, typename I>
void sais_core(const C* s, I* sa, I n, I K) {
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    std::vector<uint8_t> t_vec((size_t)n);
    uint8_t* t = t_vec.data();
    t[(size_t)(n - 1)] = 1;  // sentinel suffix is S-type
    for (I i = n - 2; i >= 0; --i)
        t[(size_t)i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[(size_t)(i + 1)]);

    auto is_lms = [&](I i) { return i > 0 && t[(size_t)i] && !t[(size_t)(i - 1)]; };

    std::vector<I> bkt((size_t)K + 1);

    // ---- stage 1: sort LMS substrings by induced sorting ----
    get_buckets<C, I>(s, bkt.data(), n, K, true);
    for (I i = 0; i < n; ++i) sa[i] = -1;
    for (I i = 1; i < n; ++i)
        if (is_lms(i)) sa[--bkt[(I)s[i]]] = i;
    induce_l<C, I>(s, sa, t, bkt.data(), n, K);
    induce_s<C, I>(s, sa, t, bkt.data(), n, K);

    // compact sorted LMS positions into sa[0..n1)
    I n1 = 0;
    for (I i = 0; i < n; ++i)
        if (is_lms(sa[i])) sa[n1++] = sa[i];

    // name LMS substrings into sa[n1..n)
    for (I i = n1; i < n; ++i) sa[i] = -1;
    I name = 0, prev = -1;
    for (I i = 0; i < n1; ++i) {
        I pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (I d = 0;; ++d) {
                if (s[pos + d] != s[prev + d] || t[(size_t)(pos + d)] != t[(size_t)(prev + d)]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
            }
        }
        if (diff) {
            ++name;
            prev = pos;
        }
        sa[n1 + pos / 2] = name - 1;
    }
    for (I i = n - 1, j = n - 1; i >= n1; --i)
        if (sa[i] >= 0) sa[j--] = sa[i];

    // ---- recurse if names are not unique ----
    I* s1 = sa + n - n1;
    if (name < n1) {
        sais_core<I, I>(s1, sa, n1, name - 1);
    } else {
        for (I i = 0; i < n1; ++i) sa[s1[i]] = i;
    }

    // map reduced SA back to LMS positions (s1 reused as position list)
    {
        I k = 0;
        for (I i = 1; i < n; ++i)
            if (is_lms(i)) s1[k++] = i;
        for (I i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
    }

    // ---- stage 2: induce the full SA from sorted LMS suffixes ----
    for (I i = n1; i < n; ++i) sa[i] = -1;
    get_buckets<C, I>(s, bkt.data(), n, K, true);
    for (I i = n1 - 1; i >= 0; --i) {
        I j = sa[i];
        sa[i] = -1;
        sa[--bkt[(I)s[j]]] = j;
    }
    induce_l<C, I>(s, sa, t, bkt.data(), n, K);
    induce_s<C, I>(s, sa, t, bkt.data(), n, K);
}

}  // namespace

extern "C" {

// Suffix array of the uint8 string s[0..n) whose last byte is the unique
// smallest symbol.  Writes n entries to sa_out.  Returns 0 on success.
int32_t sview_sais_u8(const uint8_t* s, int64_t* sa_out, int64_t n) {
    if (n <= 0) return 1;
    for (int64_t i = 0; i + 1 < n; ++i)
        if (s[i] <= s[n - 1]) return 2;  // sentinel not unique smallest
    if (n < (int64_t)1 << 31) {
        std::vector<int32_t> sa((size_t)n);
        sais_core<uint8_t, int32_t>(s, sa.data(), (int32_t)n, (int32_t)255);
        for (int64_t i = 0; i < n; ++i) sa_out[i] = sa[(size_t)i];
    } else {
        sais_core<uint8_t, int64_t>(s, sa_out, n, (int64_t)255);
    }
    return 0;
}

// int32 variant for n < 2^31: writes straight into sa_out, no widening copy
// and no 8n-byte output buffer (the 1 Gbp build path).
int32_t sview_sais_u8_i32(const uint8_t* s, int32_t* sa_out, int64_t n) {
    if (n <= 0 || n >= (int64_t)1 << 31) return 1;
    for (int64_t i = 0; i + 1 < n; ++i)
        if (s[i] <= s[n - 1]) return 2;  // sentinel not unique smallest
    sais_core<uint8_t, int32_t>(s, sa_out, (int32_t)n, (int32_t)255);
    return 0;
}

}  // extern "C"
