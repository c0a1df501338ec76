/* Inflate and dequantize int8 KV blocks of the store's codec on the host,
 * a chunk of blocks per call, with no Python object touched: bound with
 * ctypes, whose foreign calls release the interpreter lock, so the chunks
 * of one get decode on separate cores without handing the lock back and
 * forth between a block's zlib and numpy calls.
 *
 * The arithmetic is ``core/codec.py``'s, bit for bit:
 *
 *     out[r, c] = (f16)((float)q[r, c] * scale[c])     (f32: no cast)
 *
 * with the f32 product rounded once (built with -ffp-contract=off, no
 * fast-math) and the f16 cast rounded to nearest-even, as numpy's
 * ``astype(float16)`` does, NaN payloads kept as numpy keeps them.
 *
 * zlib's ``uncompress`` is passed in as a pointer (the caller takes it from
 * the runtime libz.so.1), so the source needs neither zlib's header nor a
 * link against it.  C99 for a little-endian host (the scales are read as
 * native floats); one entry point, ``block_decode_int8``.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int (*uncompress_fn)(unsigned char *dest, unsigned long *dest_len,
                             const unsigned char *src, unsigned long src_len);

enum {
    BD_OK = 0,
    BD_BODY_SIZE = 1,     /* an uncompressed body of the wrong length */
    BD_INFLATE = 2,       /* uncompress failed (corrupt or oversized stream) */
    BD_INFLATED_SIZE = 3, /* the stream inflated to fewer bytes than the shape needs */
    BD_NO_MEMORY = 4,
};

static inline uint32_t f32_bits(float x) {
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    return u;
}

static inline float bits_f32(uint32_t u) {
    float x;
    memcpy(&x, &u, sizeof x);
    return x;
}

/* f32 -> f16 bits, round to nearest-even; branch-free (masks, not
 * conditionals) so the row loop vectorises.  Every candidate is computed
 * and one selected:
 *   |x| >= 65536 or inf / NaN: inf, or NaN with the top 10 payload bits
 *     (at least one set, as numpy's npy_floatbits_to_halfbits keeps it);
 *   |x| < 2^-14: a subnormal (or zero), rounded by the FPU in adding 0.5,
 *     whose ulp is the subnormal step 2^-24;
 *   otherwise: rebias the exponent and round on bit 13, ties to the even
 *     mantissa; a carry out of the mantissa steps the exponent, and up to
 *     inf at 65520. */
static inline uint16_t f32_to_f16(float x) {
    uint32_t u = f32_bits(x);
    uint32_t sign = (u >> 16) & 0x8000u;
    uint32_t a = u & 0x7fffffffu;
    uint32_t nan_sig = (a & 0x007fffffu) >> 13;
    uint32_t is_nan = -(uint32_t)(a > 0x7f800000u);
    uint32_t big = 0x7c00u | (is_nan & (nan_sig | (nan_sig == 0)));
    uint32_t sub = f32_bits(bits_f32(a) + 0.5f) - 0x3f000000u;
    uint32_t norm = (a + 0xc8000fffu + ((a >> 13) & 1u)) >> 13;
    uint32_t is_big = -(uint32_t)(a >= 0x47800000u);
    uint32_t is_sub = -(uint32_t)(a < 0x38800000u);
    uint32_t h = (big & is_big) | (sub & is_sub) | (norm & ~(is_big | is_sub));
    return (uint16_t)(h | sign);
}

static void dequant_f16(const int8_t *q, const float *scale, uint64_t rows, uint64_t cols, uint16_t *out) {
    for (uint64_t r = 0; r < rows; ++r) {
        const int8_t *qr = q + r * cols;
        uint16_t *o = out + r * cols;
        for (uint64_t c = 0; c < cols; ++c)
            o[c] = f32_to_f16((float)qr[c] * scale[c]);
    }
}

static void dequant_f32(const int8_t *q, const float *scale, uint64_t rows, uint64_t cols, float *out) {
    for (uint64_t r = 0; r < rows; ++r) {
        const int8_t *qr = q + r * cols;
        float *o = out + r * cols;
        for (uint64_t c = 0; c < cols; ++c)
            o[c] = (float)qr[c] * scale[c];
    }
}

/* Decode ``n`` int8 payload bodies (what follows each payload's header).
 * Block i: ``body[i]`` of ``body_len[i]`` bytes, deflated if
 * ``zlibbed[i]``, holds ``cols[i]`` little-endian f32 scales then
 * ``rows[i] * cols[i]`` int8 values (rows: the product of the leading
 * dims); ``out[i]`` receives ``rows[i] * cols[i]`` values, f32 if
 * ``f32[i]`` else f16 bits; the caller has checked that every size fits
 * (``need`` below cannot overflow).  ``status[i]`` is 0 when block i was decoded,
 * else one of the codes above and ``out[i]`` is unspecified: the caller
 * decodes such a block again with the codec, which names the error. */
void block_decode_int8(int64_t n, const uint8_t *const *body, const uint64_t *body_len,
                       const uint8_t *zlibbed, const uint64_t *rows, const uint64_t *cols,
                       const uint8_t *f32, void *const *out, uncompress_fn uncompress,
                       int32_t *status) {
    uint64_t scratch_len = 1, scale_len = 1;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t need = 4 * cols[i] + rows[i] * cols[i];
        if (zlibbed[i] && need > scratch_len) scratch_len = need;
        if (cols[i] > scale_len) scale_len = cols[i];
    }
    uint8_t *scratch = malloc(scratch_len);
    float *scale = malloc(scale_len * sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
        uint64_t need = 4 * cols[i] + rows[i] * cols[i];
        const uint8_t *raw = body[i];
        if (!scratch || !scale) {
            status[i] = BD_NO_MEMORY;
            continue;
        }
        if (zlibbed[i]) {
            unsigned long got = (unsigned long)need;
            if (uncompress(scratch, &got, body[i], (unsigned long)body_len[i]) != 0) {
                status[i] = BD_INFLATE;
                continue;
            }
            if (got != need) {
                status[i] = BD_INFLATED_SIZE;
                continue;
            }
            raw = scratch;
        } else if (body_len[i] != need) {
            status[i] = BD_BODY_SIZE;
            continue;
        }
        memcpy(scale, raw, 4 * cols[i]); /* the scales may sit unaligned */
        const int8_t *q = (const int8_t *)(raw + 4 * cols[i]);
        if (f32[i])
            dequant_f32(q, scale, rows[i], cols[i], (float *)out[i]);
        else
            dequant_f16(q, scale, rows[i], cols[i], (uint16_t *)out[i]);
        status[i] = BD_OK;
    }
    free(scratch);
    free(scale);
}
