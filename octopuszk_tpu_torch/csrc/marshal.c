/* Host marshaling between packed little-endian byte records (python's
 * int.to_bytes) and the word-major int32[8, n] layout of a field batch,
 * both directions, without a loop in python.
 *
 * The port's counterpart of the reference's native/marshal.c (16-bit
 * limbs there, 32-bit words here).  Built with the host's C compiler by
 * utils/native.py build() and bound with ctypes.  utils/bigint.py's numpy
 * transpose gives the same words; the port's host code calls that one.
 *
 * bytes_to_words: record i is bytes_in[i * nbytes .. (i + 1) * nbytes),
 * 1 <= nbytes <= 32; word k of record i goes to words_out[k * n + i], the
 * bytes past the record's end read as zero.  words_to_bytes: the reverse
 * with 32-byte records.
 */

#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))
#define NUM_WORDS 8

/* a word as little-endian bytes hold it (a no-op on a little-endian host) */
static inline uint32_t le32(uint32_t v) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    return __builtin_bswap32(v);
#else
    return v;
#endif
}

EXPORT void bytes_to_words(const uint8_t *bytes_in, int64_t n, int64_t nbytes,
                           uint32_t *words_out) {
    /* one pass over the records, a 4-byte load per word */
    for (int64_t i = 0; i < n; i++) {
        uint8_t rec[4 * NUM_WORDS] = {0};
        memcpy(rec, bytes_in + i * nbytes, (size_t)nbytes);
        for (int64_t k = 0; k < NUM_WORDS; k++) {
            uint32_t v;
            memcpy(&v, rec + 4 * k, 4);
            words_out[k * n + i] = le32(v);
        }
    }
}

EXPORT void words_to_bytes(const uint32_t *words_in, int64_t n,
                           uint8_t *bytes_out) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t *p = bytes_out + i * 4 * NUM_WORDS;
        for (int64_t k = 0; k < NUM_WORDS; k++) {
            const uint32_t v = le32(words_in[k * n + i]);
            memcpy(p + 4 * k, &v, 4);
        }
    }
}
