/* bam_ingest.c — BAM input staged straight into the fast lane's batches.
 *
 * One pass from BGZF-compressed BAM to the arrays that the shared
 * parse_stage_batch (native/fastpath.c) returns for the same records
 * given as SAM text lines: BGZF inflate (blocks in parallel over
 * pthreads), the binary record decoded, the reader-loop filters (flag
 * skip, secondary skip, missing ref, missing pos, missing seq), the batch
 * cut after exactly batch_size kept records, and every staged buffer
 * written from the binary fields.  Each kept record's SAM text (as
 * bam_to_sam_lines writes it, without the newline) goes into the arena,
 * because the splice that formats the output reads QNAME, SEQ, QUAL and
 * the tags from there.  No SAM text is parsed back.
 *
 * Plain C, no Python: bound by ctypes, so every call runs without the
 * GIL.  The caller feeds compressed bytes (bi_feed) and asks for batches
 * (bi_next); a finished batch's buffers are malloc'd and handed over, and
 * the caller frees each with bi_release.
 *
 * Errors carry the messages of the text path (bam_to_sam_lines,
 * parse_stage_batch and SamReader's BGZF reader) for the same input.
 */

#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define CODE_NONE 15
#define N_OUT 13

/* op codes follow the BAM encoding MIDNSHP=X; 9..15 are no SAM op */
static const char op_chars[16] = "MIDNSHP=X??????\0";

static inline int is_ref_op(int op)
{
    return op == 0 || op == 7 || op == 8 || op == 2 || op == 3; /* M = X D N */
}

static inline int is_query_op(int op)
{
    return op == 1 || op == 4 || op == 0 || op == 7 || op == 8; /* I S M = X */
}

/* BAM nibble code -> SAM base (SAM specification 4.2.3), and a packed
   SEQ byte -> its two bases */
static const char base16[17] = "=ACMGRSVTWYHKDBN";
static char base_pairs[256][2];
static pthread_once_t base_pairs_once = PTHREAD_ONCE_INIT;

static void base_pairs_init(void)
{
    for (int c = 0; c < 256; ++c) {
        base_pairs[c][0] = base16[c >> 4];
        base_pairs[c][1] = base16[c & 0xF];
    }
}

typedef struct {
    uint8_t *p;
    size_t len, cap;
} buf_t;

static int reserve(buf_t *b, size_t extra)
{
    if (b->len + extra <= b->cap)
        return 0;
    size_t cap = b->cap ? b->cap : 4096;
    while (cap < b->len + extra)
        cap *= 2;
    uint8_t *np = realloc(b->p, cap);
    if (!np)
        return -1;
    b->p = np;
    b->cap = cap;
    return 0;
}

static inline void put(buf_t *b, const void *s, size_t n)
{
    memcpy(b->p + b->len, s, n);
    b->len += n;
}

static inline void putc_(buf_t *b, char c)
{
    b->p[b->len++] = (uint8_t)c;
}

static inline void put_long(buf_t *b, long v)
{
    unsigned long u = (v < 0) ? 0UL - (unsigned long)v : (unsigned long)v;
    if (v < 0)
        b->p[b->len++] = '-';
    int nd = 1;
    for (unsigned long t = u; t >= 10; t /= 10)
        ++nd;
    char *q = (char *)b->p + b->len + nd;
    do {
        *--q = (char)('0' + (u % 10));
        u /= 10;
    } while (u);
    b->len += nd;
}

static inline void push_i32(buf_t *b, int32_t v)
{
    memcpy(b->p + b->len, &v, 4);
    b->len += 4;
}

static inline uint32_t le32(const uint8_t *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* float32 as the port's SAM writer prints it: the shortest digits that
   round-trip, fixed unless scientific is strictly shorter (a copy of
   pv3_format_f32 in native/fastpath.c, which bam_to_sam_lines uses) */
static int format_f32(double dv, char *out)
{
    float f = (float)dv;
    if (isnan(f)) {
        if (signbit(f)) {
            memcpy(out, "-nan", 5);
            return 4;
        }
        memcpy(out, "nan", 4);
        return 3;
    }
    if (isinf(f)) {
        if (f < 0) {
            memcpy(out, "-inf", 5);
            return 4;
        }
        memcpy(out, "inf", 4);
        return 3;
    }
    double fd = (double)f;
    if (fd == 0.0) {
        if (signbit(f)) {
            memcpy(out, "-0", 3);
            return 2;
        }
        memcpy(out, "0", 2);
        return 1;
    }
    static const long long pow10q[10] = {
        1LL, 10LL, 100LL, 1000LL, 10000LL, 100000LL,
        1000000LL, 10000000LL, 100000000LL, 1000000000LL,
    };
    char ebuf[48], digits[16];
    int neg = fd < 0.0, nd = 0, exp10 = 0;
    for (int q = 1; q <= 9; ++q) {
        snprintf(ebuf, sizeof ebuf, "%.*e", q - 1, fd);
        const char *c = ebuf;
        long long m = 0;
        if (*c == '-')
            ++c;
        for (; *c && *c != 'e' && *c != 'E'; ++c)
            if ('0' <= *c && *c <= '9')
                m = m * 10 + (*c - '0');
        int xe = (int)strtol(c + 1, NULL, 10);
        if (strtof(ebuf, NULL) == f) {
            nd = q;
            exp10 = xe;
            for (int i = q - 1; i >= 0; --i, m /= 10)
                digits[i] = (char)('0' + (m % 10));
            break;
        }
        for (int delta = -1; delta <= 1; delta += 2) {
            long long m2 = m + delta;
            if (m2 < pow10q[q - 1] || m2 >= pow10q[q])
                continue;
            char nbuf[48];
            snprintf(nbuf, sizeof nbuf, "%s%lldE%d", neg ? "-" : "", m2,
                     xe - q + 1);
            if (strtof(nbuf, NULL) == f) {
                nd = q;
                exp10 = xe;
                for (int i = q - 1; i >= 0; --i, m2 /= 10)
                    digits[i] = (char)('0' + (m2 % 10));
                break;
            }
        }
        if (nd)
            break;
    }
    if (!nd) {
        snprintf(ebuf, sizeof ebuf, "%.8e", fd);
        const char *c = ebuf;
        if (*c == '-')
            ++c;
        for (; *c && *c != 'e' && *c != 'E'; ++c)
            if ('0' <= *c && *c <= '9')
                digits[nd++] = *c;
        exp10 = (int)strtol(c + 1, NULL, 10);
    }
    char pos_b[64], sci_b[32];
    int pos_n = 0, sci_n = 0;
    if (exp10 >= 0) {
        if (nd < exp10 + 1) {
            double af = fabs(fd);
            if (af == floor(af)) {
                pos_n = sprintf(pos_b, "%.0f", af);
            } else {
                memcpy(pos_b, digits, nd);
                pos_n = nd;
                for (int i = nd; i <= exp10; ++i)
                    pos_b[pos_n++] = '0';
            }
        } else if (nd == exp10 + 1) {
            memcpy(pos_b, digits, nd);
            pos_n = nd;
        } else {
            memcpy(pos_b, digits, exp10 + 1);
            pos_n = exp10 + 1;
            pos_b[pos_n++] = '.';
            memcpy(pos_b + pos_n, digits + exp10 + 1, nd - exp10 - 1);
            pos_n += nd - exp10 - 1;
        }
    } else {
        pos_b[pos_n++] = '0';
        pos_b[pos_n++] = '.';
        for (int i = 0; i < -exp10 - 1; ++i)
            pos_b[pos_n++] = '0';
        memcpy(pos_b + pos_n, digits, nd);
        pos_n += nd;
    }
    sci_b[sci_n++] = digits[0];
    if (nd > 1) {
        sci_b[sci_n++] = '.';
        memcpy(sci_b + sci_n, digits + 1, nd - 1);
        sci_n += nd - 1;
    }
    sci_n += sprintf(sci_b + sci_n, "e%+03d", exp10);
    char *src = pos_n <= sci_n ? pos_b : sci_b;
    int n = pos_n <= sci_n ? pos_n : sci_n;
    char *w = out;
    if (neg)
        *w++ = '-';
    memcpy(w, src, n);
    w[n] = 0;
    return n + neg;
}

/* ---- BGZF ------------------------------------------------------------ */

typedef struct {
    size_t cdata_off;
    uint32_t cdata_len, isize;
    size_t out_off;
} blk_t;

typedef struct {
    const uint8_t *in;
    uint8_t *out;
    const blk_t *blks;
    size_t nblocks;
    int nthreads, tid, error;
} dec_job;

static void *dec_worker(void *arg)
{
    dec_job *job = arg;
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, -15) != Z_OK) {
        job->error = 1;
        return NULL;
    }
    for (size_t b = job->tid; b < job->nblocks; b += job->nthreads) {
        const blk_t *blk = job->blks + b;
        inflateReset(&zs);
        zs.next_in = (Bytef *)(job->in + blk->cdata_off);
        zs.avail_in = blk->cdata_len;
        zs.next_out = job->out + blk->out_off;
        zs.avail_out = blk->isize;
        int rc = inflate(&zs, Z_FINISH);
        if (rc != Z_STREAM_END || zs.total_out != blk->isize) {
            job->error = 1;
            break;
        }
        uint32_t crc = crc32(0L, Z_NULL, 0);
        crc = crc32(crc, job->out + blk->out_off, blk->isize);
        if (crc != le32(job->in + blk->cdata_off + blk->cdata_len)) {
            job->error = 1;
            break;
        }
    }
    inflateEnd(&zs);
    return NULL;
}

/* A step of whole blocks, inflating on threads of its own while the
   caller decodes what the step before gave: its compressed bytes copied
   out of the input, its output written FRONT bytes into its buffer, so
   that the undecoded tail before it can be put in front without a copy
   of the step's bytes. */
#define FRONT ((size_t)1 << 16)

typedef struct {
    buf_t in, out;
    blk_t *blks;
    size_t nblocks, cap, out_total;
    int nthreads, active;
    int spawned[64];
    pthread_t tids[64];
    dec_job jobs[64];
} step_t;

/* ---- state ----------------------------------------------------------- */

enum { B_ARENA, B_SPANS, B_LINE, B_FIELDS, B_NOPS, B_REFUNITS, B_UNITS,
       B_FOPS, B_FCOUNTS, N_REC_BUFS };

typedef struct {
    /* configuration */
    int32_t n_refs;
    int32_t *lut;        /* BAM ref id -> input ref id; -2 not in the map */
    char **names;        /* the header's names, as the SAM text shows them */
    int32_t *name_len;
    long flag_skip, primary_mask;
    int64_t batch_size;
    int32_t min_O, min_R, min_Lq;
    int n_threads;
    /* input: compressed bytes not yet inflated, the step inflating, and
       inflated bytes not yet decoded (from plain_pos); pending_err: a bad
       block header met ahead of the decode, reported once the data before
       it is decoded */
    buf_t comp, plain;
    size_t plain_pos;
    step_t step;
    int pending_err;
    /* the batch being cut: per kept record, as parse_stage_batch's loop
       collects them */
    buf_t rec[N_REC_BUFS];
    size_t last_len[N_REC_BUFS];
    int64_t n_records, kept, c_flags, c_ref_missing, c_seq_missing;
    int32_t max_ops, max_units, max_q;
    int64_t total_units;
    buf_t scratch;       /* one record's SAM text, for an error message */
    char err[512];
} bi_state;

static void reset_batch(bi_state *h)
{
    h->n_records = h->kept = 0;
    h->c_flags = h->c_ref_missing = h->c_seq_missing = 0;
    h->max_ops = h->max_units = h->max_q = 1;
    h->total_units = 0;
}

void bi_free(bi_state *h)
{
    if (!h)
        return;
    free(h->lut);
    if (h->names)
        for (int32_t i = 0; i < h->n_refs; ++i)
            free(h->names[i]);
    free(h->names);
    free(h->name_len);
    if (h->step.active)
        for (int t = 0; t < h->step.nthreads; ++t)
            if (h->step.spawned[t])
                pthread_join(h->step.tids[t], NULL);
    free(h->step.in.p);
    free(h->step.out.p);
    free(h->step.blks);
    free(h->comp.p);
    free(h->plain.p);
    for (int k = 0; k < N_REC_BUFS; ++k)
        free(h->rec[k].p);
    free(h->scratch.p);
    free(h);
}

/* names_blob holds the n_refs names back to back, name i at
   name_off[i] .. name_off[i + 1] */
bi_state *bi_new(int32_t n_refs, const int32_t *lut, const char *names_blob,
                 const int64_t *name_off, long flag_skip, long primary_mask,
                 int64_t batch_size, int32_t min_O, int32_t min_R,
                 int32_t min_Lq, int n_threads)
{
    pthread_once(&base_pairs_once, base_pairs_init);
    bi_state *h = calloc(1, sizeof *h);
    if (!h)
        return NULL;
    h->n_refs = n_refs;
    h->lut = malloc((n_refs ? n_refs : 1) * sizeof(int32_t));
    h->names = calloc(n_refs ? n_refs : 1, sizeof(char *));
    h->name_len = malloc((n_refs ? n_refs : 1) * sizeof(int32_t));
    if (!h->lut || !h->names || !h->name_len) {
        bi_free(h);
        return NULL;
    }
    for (int32_t i = 0; i < n_refs; ++i) {
        int64_t len = name_off[i + 1] - name_off[i];
        h->lut[i] = lut[i];
        h->name_len[i] = (int32_t)len;
        h->names[i] = malloc(len ? len : 1);
        if (!h->names[i]) {
            bi_free(h);
            return NULL;
        }
        memcpy(h->names[i], names_blob + name_off[i], len);
    }
    h->flag_skip = flag_skip;
    h->primary_mask = primary_mask;
    h->batch_size = batch_size;
    h->min_O = min_O;
    h->min_R = min_R;
    h->min_Lq = min_Lq;
    h->n_threads = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
    reset_batch(h);
    return h;
}

/* compressed input, appended */
int bi_feed(bi_state *h, const uint8_t *data, int64_t n)
{
    if (reserve(&h->comp, (size_t)n) < 0)
        return -1;
    put(&h->comp, data, (size_t)n);
    return 0;
}

/* inflated input, appended (what the header's reader had inflated past
   the header) */
int bi_feed_plain(bi_state *h, const uint8_t *data, int64_t n)
{
    if (reserve(&h->plain, (size_t)n) < 0)
        return -1;
    put(&h->plain, data, (size_t)n);
    return 0;
}

void bi_release(void *p)
{
    free(p);
}

const char *bi_error(const bi_state *h)
{
    return h->err;
}

/* Whole blocks a step: ~4 MiB of records, a batch or two, so that no
   batch waits on a whole read's worth of blocks. */
#define STEP_BLOCKS 64
/* compressed bytes below which the caller is asked to read ahead, so the
   file's read overlaps the inflate and the decode */
#define READ_AHEAD ((size_t)1 << 21)

/* Starts inflating the whole blocks at the head of the compressed input,
   at most STEP_BLOCKS, unless a step is inflating.  The header checks are
   SamReader's (whole_block_prefix), then bgzf_decompress's; a bad header
   ends the step before it and is kept as pending_err.  Returns -2 out of
   memory, else 0 (h->step.active says whether a step started). */
static int step_launch(bi_state *h)
{
    step_t *st = &h->step;
    if (st->active || h->pending_err)
        return 0;
    const uint8_t *in = h->comp.p;
    size_t len = h->comp.len, off = 0, out_total = 0;
    st->nblocks = 0;
    while (off < len && st->nblocks < STEP_BLOCKS) {
        if (off + 12 > len)
            break;
        if (in[off] != 0x1f || in[off + 1] != 0x8b || in[off + 2] != 0x08 ||
            in[off + 3] != 0x04) {
            snprintf(h->err, sizeof h->err, "not a BGZF block");
            h->pending_err = 1;
            break;
        }
        uint32_t xlen = (uint32_t)in[off + 10] | ((uint32_t)in[off + 11] << 8);
        if (off + 12 + xlen > len)
            break;
        uint32_t bsize = 0;
        int found = 0;
        size_t xo = off + 12, xend = off + 12 + xlen;
        while (xo + 4 <= xend) {
            uint32_t slen = (uint32_t)in[xo + 2] | ((uint32_t)in[xo + 3] << 8);
            if (in[xo] == 'B' && in[xo + 1] == 'C' && slen == 2 &&
                xo + 6 <= xend) {
                bsize = ((uint32_t)in[xo + 4] | ((uint32_t)in[xo + 5] << 8)) + 1;
                found = 1;
                break;
            }
            xo += 4 + slen;
        }
        if (!found) {
            snprintf(h->err, sizeof h->err, "BGZF block without BC subfield");
            h->pending_err = 1;
            break;
        }
        if (off + bsize > len)
            break;
        if (bsize < 12 + xlen + 8) {
            snprintf(h->err, sizeof h->err, "BGZF block without valid BC size");
            h->pending_err = 1;
            break;
        }
        if (st->nblocks == st->cap) {
            size_t cap = st->cap ? st->cap * 2 : STEP_BLOCKS;
            blk_t *nb = realloc(st->blks, cap * sizeof *nb);
            if (!nb)
                goto oom;
            st->blks = nb;
            st->cap = cap;
        }
        st->blks[st->nblocks++] = (blk_t){
            .cdata_off = off + 12 + xlen,
            .cdata_len = bsize - 12 - xlen - 8,
            .isize = le32(in + off + bsize - 4),
            .out_off = out_total,
        };
        out_total += st->blks[st->nblocks - 1].isize;
        off += bsize;
    }
    if (!st->nblocks)
        return 0;
    st->in.len = st->out.len = 0;
    if (reserve(&st->in, off) < 0 || reserve(&st->out, FRONT + out_total) < 0)
        goto oom;
    put(&st->in, h->comp.p, off);
    memmove(h->comp.p, h->comp.p + off, len - off);
    h->comp.len = len - off;
    st->out_total = out_total;
    st->nthreads = h->n_threads < (int)st->nblocks ? h->n_threads : (int)st->nblocks;
    for (int t = 0; t < st->nthreads; ++t) {
        st->jobs[t] = (dec_job){
            .in = st->in.p, .out = st->out.p + FRONT, .blks = st->blks,
            .nblocks = st->nblocks, .nthreads = st->nthreads, .tid = t,
            .error = 0,
        };
        st->spawned[t] = !pthread_create(&st->tids[t], NULL, dec_worker, &st->jobs[t]);
        if (!st->spawned[t])
            dec_worker(&st->jobs[t]);
    }
    st->active = 1;
    return 0;
oom:
    snprintf(h->err, sizeof h->err, "out of memory");
    return -2;
}

/* Waits for the inflating step and puts its bytes after the undecoded
   tail of the inflated input: 0, or -1 with h->err set (-2 no memory). */
static int step_join(bi_state *h)
{
    step_t *st = &h->step;
    int error = 0;
    for (int t = 0; t < st->nthreads; ++t) {
        if (st->spawned[t])
            pthread_join(st->tids[t], NULL);
        error |= st->jobs[t].error;
    }
    st->active = 0;
    if (error) {
        snprintf(h->err, sizeof h->err,
                 "BGZF inflate failed (corrupt block or CRC)");
        return -1;
    }
    size_t tail = h->plain.len - h->plain_pos;
    if (tail <= FRONT) {
        /* the tail in front of the step's bytes, and the buffers swapped */
        if (tail)
            memcpy(st->out.p + FRONT - tail, h->plain.p + h->plain_pos, tail);
        buf_t old = h->plain;
        h->plain = st->out;
        h->plain.len = FRONT + st->out_total;
        h->plain_pos = FRONT - tail;
        st->out = old;
        return 0;
    }
    memmove(h->plain.p, h->plain.p + h->plain_pos, tail);
    h->plain.len = tail;
    h->plain_pos = 0;
    if (reserve(&h->plain, st->out_total) < 0) {
        snprintf(h->err, sizeof h->err, "out of memory");
        return -2;
    }
    put(&h->plain, st->out.p + FRONT, st->out_total);
    return 0;
}

/* ---- records --------------------------------------------------------- */

/* the record's SAM text as bam_to_sam_lines writes it (tags checked by
   the caller), with the newline; offsets of SEQ, QUAL and the tags */
typedef struct {
    size_t seq, qual, qual_len, tags;
} text_offs;

static int render(const bi_state *h, buf_t *b, const uint8_t *r, uint32_t size,
                  text_offs *o)
{
    int32_t ref_id, pos, next_ref, next_pos, tlen, l_seq;
    uint16_t n_cigar, flag;
    memcpy(&ref_id, r, 4);
    memcpy(&pos, r + 4, 4);
    uint8_t l_read_name = r[8], mapq = r[9];
    memcpy(&n_cigar, r + 12, 2);
    memcpy(&flag, r + 14, 2);
    memcpy(&l_seq, r + 16, 4);
    memcpy(&next_ref, r + 20, 4);
    memcpy(&next_pos, r + 24, 4);
    memcpy(&tlen, r + 28, 4);
    size_t nb = ((size_t)l_seq + 1) / 2;
    const uint8_t *cig = r + 32 + l_read_name;
    const uint8_t *sq = cig + 4u * n_cigar;
    const uint8_t *ql = sq + nb;
    size_t p = (size_t)(ql - r) + (size_t)l_seq;
    /* an upper bound of the text: the fixed fields, the names, 11 chars a
       CIGAR op, SEQ and QUAL, and 16 chars a tag byte (a float is at most
       15 chars from 4 bytes, a B element at most 16 from 1..4) */
    size_t need = 160 + (size_t)l_read_name + 11u * n_cigar + 2u * l_seq +
                  16u * (size - p);
    if (ref_id >= 0)
        need += h->name_len[ref_id];
    if (next_ref >= 0)
        need += h->name_len[next_ref];
    if (reserve(b, need) < 0)
        return -1;
    put(b, r + 32, l_read_name - 1u);
    putc_(b, '\t');
    put_long(b, flag);
    putc_(b, '\t');
    if (ref_id < 0)
        putc_(b, '*');
    else
        put(b, h->names[ref_id], h->name_len[ref_id]);
    putc_(b, '\t');
    put_long(b, (long)pos + 1);
    putc_(b, '\t');
    put_long(b, mapq);
    putc_(b, '\t');
    if (n_cigar == 0) {
        putc_(b, '*');
    } else {
        for (uint16_t c = 0; c < n_cigar; ++c) {
            uint32_t v = le32(cig + 4u * c);
            put_long(b, v >> 4);
            putc_(b, op_chars[v & 0xF]);
        }
    }
    putc_(b, '\t');
    if (next_ref < 0)
        putc_(b, '*');
    else if (next_ref == ref_id)
        putc_(b, '=');
    else
        put(b, h->names[next_ref], h->name_len[next_ref]);
    putc_(b, '\t');
    put_long(b, (long)next_pos + 1);
    putc_(b, '\t');
    put_long(b, tlen);
    putc_(b, '\t');
    o->seq = b->len;
    if (l_seq == 0) {
        putc_(b, '*');
        putc_(b, '\t');
        o->qual = b->len;
        putc_(b, '*');
        o->qual_len = 1;
    } else {
        char *w = (char *)b->p + b->len;
        for (int32_t i = 0; i < l_seq / 2; ++i)
            memcpy(w + 2 * i, base_pairs[sq[i]], 2);
        if (l_seq & 1)
            w[l_seq - 1] = base16[sq[l_seq / 2] >> 4];
        b->len += l_seq;
        putc_(b, '\t');
        o->qual = b->len;
        w = (char *)b->p + b->len;
        if (ql[0] == 0xFF) {
            w[0] = '*';
            b->len += 1;
            o->qual_len = 1;
        } else {
            for (int32_t i = 0; i < l_seq; ++i)
                w[i] = (char)(ql[i] + 33);
            b->len += l_seq;
            o->qual_len = l_seq;
        }
    }
    o->tags = 0;
    while (p + 3 <= size) {
        char typ = (char)r[p + 2];
        putc_(b, '\t');
        if (!o->tags)
            o->tags = b->len;
        putc_(b, (char)r[p]);
        putc_(b, (char)r[p + 1]);
        putc_(b, ':');
        p += 3;
        char fbuf[64];
        switch (typ) {
        case 'A':
            put(b, "A:", 2);
            putc_(b, (char)r[p]);
            p += 1;
            break;
        case 'c': case 'C': case 's': case 'S': case 'i': case 'I': {
            long iv;
            if (typ == 'c') {
                iv = (int8_t)r[p];
                p += 1;
            } else if (typ == 'C') {
                iv = r[p];
                p += 1;
            } else if (typ == 's') {
                int16_t v;
                memcpy(&v, r + p, 2);
                iv = v;
                p += 2;
            } else if (typ == 'S') {
                uint16_t v;
                memcpy(&v, r + p, 2);
                iv = v;
                p += 2;
            } else if (typ == 'i') {
                int32_t v;
                memcpy(&v, r + p, 4);
                iv = v;
                p += 4;
            } else {
                iv = le32(r + p);
                p += 4;
            }
            put(b, "i:", 2);
            put_long(b, iv);
            break;
        }
        case 'f': {
            float v;
            memcpy(&v, r + p, 4);
            p += 4;
            put(b, "f:", 2);
            put(b, fbuf, format_f32(v, fbuf));
            break;
        }
        case 'Z': case 'H': {
            const uint8_t *z = memchr(r + p, 0, size - p);
            putc_(b, typ);
            putc_(b, ':');
            put(b, r + p, (size_t)(z - (r + p)));
            p = (size_t)(z - r) + 1;
            break;
        }
        default: { /* 'B' */
            char sub = (char)r[p];
            uint32_t cnt = le32(r + p + 1);
            p += 5;
            int w = (sub == 'c' || sub == 'C') ? 1
                    : (sub == 's' || sub == 'S') ? 2 : 4;
            put(b, "B:", 2);
            putc_(b, sub);
            for (uint32_t j = 0; j < cnt; ++j, p += w) {
                long iv;
                putc_(b, ',');
                if (sub == 'f') {
                    float v;
                    memcpy(&v, r + p, 4);
                    put(b, fbuf, format_f32(v, fbuf));
                    continue;
                }
                if (sub == 'c')
                    iv = (int8_t)r[p];
                else if (sub == 'C')
                    iv = r[p];
                else if (sub == 's') {
                    int16_t v;
                    memcpy(&v, r + p, 2);
                    iv = v;
                } else if (sub == 'S') {
                    uint16_t v;
                    memcpy(&v, r + p, 2);
                    iv = v;
                } else if (sub == 'i') {
                    int32_t v;
                    memcpy(&v, r + p, 4);
                    iv = v;
                } else {
                    iv = le32(r + p);
                }
                put_long(b, iv);
            }
            break;
        }
        }
    }
    return 0;
}

/* bam_to_sam_lines' checks of the tag bytes, in its order: 0 where they
   decode, else the error in h->err */
static int check_tags(bi_state *h, const uint8_t *r, uint32_t size, size_t p)
{
    while (p + 3 <= size) {
        char typ = (char)r[p + 2];
        p += 3;
        switch (typ) {
        case 'A': case 'c': case 'C':
            if (p + 1 > size)
                goto trunc;
            p += 1;
            break;
        case 's': case 'S':
            if (p + 2 > size)
                goto trunc;
            p += 2;
            break;
        case 'i': case 'I': case 'f':
            if (p + 4 > size)
                goto trunc;
            p += 4;
            break;
        case 'Z': case 'H': {
            const uint8_t *z = memchr(r + p, 0, size - p);
            if (!z)
                goto trunc;
            p = (size_t)(z - r) + 1;
            break;
        }
        case 'B': {
            if (p + 5 > size)
                goto trunc;
            char sub = (char)r[p];
            uint32_t cnt = le32(r + p + 1);
            p += 5;
            size_t w = (sub == 'c' || sub == 'C') ? 1
                       : (sub == 's' || sub == 'S') ? 2 : 4;
            if (p + w * cnt > size)
                goto trunc;
            if (cnt && !strchr("cCsSiIf", sub)) {
                snprintf(h->err, sizeof h->err, "unknown BAM B subtype '%c'", sub);
                return -1;
            }
            p += w * cnt;
            break;
        }
        default:
            snprintf(h->err, sizeof h->err, "unknown BAM tag type '%c'", typ);
            return -1;
        }
    }
    return 0;
trunc:
    snprintf(h->err, sizeof h->err, "truncated BAM tag data");
    return -1;
}

/* parse_stage_batch's message for a field of the record's text: fmt with
   the text from `from` on, at most `max` bytes, as %.Ns prints it */
static int text_error(bi_state *h, const uint8_t *r, uint32_t size,
                      const char *fmt, size_t field, int max)
{
    text_offs o;
    h->scratch.len = 0;
    if (render(h, &h->scratch, r, size, &o) < 0 || reserve(&h->scratch, 2) < 0) {
        snprintf(h->err, sizeof h->err, "out of memory");
        return -2;
    }
    putc_(&h->scratch, '\n');
    putc_(&h->scratch, '\0');
    /* field 0 starts the text; field k follows the k-th tab */
    const char *s = (const char *)h->scratch.p;
    for (size_t k = 0; k < field && strchr(s, '\t'); ++k)
        s = strchr(s, '\t') + 1;
    char piece[128];
    snprintf(piece, sizeof piece, "%.*s", max, s);
    snprintf(h->err, sizeof h->err, fmt, piece);
    return -1;
}

/* One complete record (r, size) into the batch: 0 taken, -1 error (-2 no
   memory), with h->err set. */
static int take_record(bi_state *h, const uint8_t *r, uint32_t size)
{
    if (size < 32) {
        snprintf(h->err, sizeof h->err, "truncated BAM record");
        return -1;
    }
    int32_t ref_id, pos, next_ref, l_seq, next_pos, tlen;
    uint16_t n_cigar, flag;
    memcpy(&ref_id, r, 4);
    memcpy(&pos, r + 4, 4);
    uint8_t l_read_name = r[8], mapq = r[9];
    memcpy(&n_cigar, r + 12, 2);
    memcpy(&flag, r + 14, 2);
    memcpy(&l_seq, r + 16, 4);
    memcpy(&next_ref, r + 20, 4);
    memcpy(&next_pos, r + 24, 4);
    memcpy(&tlen, r + 28, 4);
    if (l_read_name == 0 || l_seq < 0) {
        snprintf(h->err, sizeof h->err, "corrupt BAM record header");
        return -1;
    }
    size_t nb = ((size_t)l_seq + 1) / 2;
    size_t body = 32 + l_read_name + 4u * n_cigar + nb + (size_t)l_seq;
    if (body > size) {
        snprintf(h->err, sizeof h->err, "truncated BAM record body");
        return -1;
    }
    if ((ref_id >= 0 && ref_id >= h->n_refs) ||
        (next_ref >= 0 && next_ref >= h->n_refs)) {
        snprintf(h->err, sizeof h->err, "BAM reference id out of range");
        return -1;
    }
    if (check_tags(h, r, size, body) < 0)
        return -1;

    /* the text path resolves RNAME and RNEXT by name before its filters */
    long rid = ref_id < 0 ? -1 : h->lut[ref_id];
    if (rid == -2)
        return text_error(h, r, size, "unknown reference '%s'", 2, 100);
    long mrid = next_ref < 0 ? -1 : (next_ref == ref_id ? rid : h->lut[next_ref]);
    if (mrid == -2)
        return text_error(h, r, size, "unknown mate reference '%s'", 6, 100);
    int64_t rec_no = h->n_records++;

    if (flag & h->flag_skip) {
        ++h->c_flags;
        return 0;
    }
    if (h->primary_mask && (flag & h->primary_mask)) {
        ++h->c_flags;
        return 0;
    }
    if (rid < 0) {
        ++h->c_ref_missing;
        return 0;
    }
    if (pos < 0) {
        ++h->c_flags;
        return 0;
    }
    if (l_seq == 0) {
        ++h->c_seq_missing;
        return 0;
    }

    /* CIGAR */
    const uint8_t *cig = r + 32 + l_read_name;
    buf_t *fops = &h->rec[B_FOPS], *fcounts = &h->rec[B_FCOUNTS];
    if (reserve(fops, n_cigar) < 0 || reserve(fcounts, 4u * n_cigar) < 0)
        goto oom;
    long qlen = 0, ref_units = 0, units = 0;
    for (uint16_t c = 0; c < n_cigar; ++c) {
        uint32_t v = le32(cig + 4u * c);
        int op = (int)(v & 0xF);
        if (op > 8)
            return text_error(h, r, size, "invalid CIGAR: '%s'", 5, 50);
        int32_t count = (int32_t)(v >> 4);
        fops->p[fops->len++] = (uint8_t)op;
        push_i32(fcounts, count);
        if (is_query_op(op))
            qlen += count;
        if (is_ref_op(op)) {
            ref_units += count;
            units += count;
        } else {
            units += 1;
        }
    }
    if (n_cigar && qlen != l_seq) {
        int n = l_read_name - 1 > 60 ? 60 : l_read_name - 1;
        snprintf(h->err, sizeof h->err,
                 "record '%.*s': CIGAR consumes %ld query bases but SEQ has %ld",
                 n, (const char *)r + 32, qlen, (long)l_seq);
        return -1;
    }

    /* the text into the arena, then the record's columns */
    buf_t *arena = &h->rec[B_ARENA];
    size_t base = arena->len;
    text_offs o;
    if (render(h, arena, r, size, &o) < 0)
        goto oom;
    size_t end = arena->len;
    /* the text path drops a line's trailing CR and LF */
    while (end > base && (arena->p[end - 1] == '\n' || arena->p[end - 1] == '\r'))
        --end;
    arena->len = end;
    size_t tags = o.tags ? o.tags : end;
    if (tags > end)
        tags = end;
    for (int k = B_SPANS; k <= B_UNITS; ++k)
        if (reserve(&h->rec[k], 32) < 0)
            goto oom;
    push_i32(&h->rec[B_LINE], (int32_t)rec_no);
    buf_t *f = &h->rec[B_FIELDS];
    push_i32(f, flag);
    push_i32(f, (int32_t)rid);
    push_i32(f, pos);
    push_i32(f, mapq);
    push_i32(f, (int32_t)mrid);
    push_i32(f, next_pos);
    push_i32(f, tlen);
    push_i32(&h->rec[B_NOPS], n_cigar);
    push_i32(&h->rec[B_REFUNITS], (int32_t)ref_units);
    push_i32(&h->rec[B_UNITS], (int32_t)units);
    buf_t *sp = &h->rec[B_SPANS];
    push_i32(sp, (int32_t)base);
    push_i32(sp, l_read_name - 1);
    push_i32(sp, (int32_t)o.seq);
    push_i32(sp, l_seq);
    push_i32(sp, (int32_t)o.qual);
    push_i32(sp, (int32_t)o.qual_len);
    push_i32(sp, (int32_t)tags);
    push_i32(sp, (int32_t)(end - tags));
    if (n_cigar > h->max_ops)
        h->max_ops = n_cigar;
    if (ref_units > h->max_units)
        h->max_units = (int32_t)ref_units;
    if (l_seq > h->max_q)
        h->max_q = l_seq;
    h->total_units += units;
    ++h->kept;
    return 0;
oom:
    snprintf(h->err, sizeof h->err, "out of memory");
    return -2;
}

static inline int32_t next_pow2(int32_t n)
{
    int32_t p = 1;
    while (p < n)
        p <<= 1;
    return p;
}

static void *own(buf_t *b, int64_t *len)
{
    void *p = b->p ? (void *)b->p : malloc(1);
    *len = (int64_t)b->len;
    b->p = NULL;
    b->len = b->cap = 0;
    return p;
}

/* The cut batch's buffers, handed over in parse_stage_batch's layout:
   arena, spans, line_index, fields, n_ops, n_ref_units, n_units, ops,
   counts, query, unit_op, unit_count, unit_rec.  info: n_records, kept,
   flags_not_matched, ref_id_missing, seq_missing, O, R, Lq. */
static int finish_batch(bi_state *h, int64_t *info, void **ptr, int64_t *len)
{
    int64_t n = h->kept;
    int32_t O = next_pow2(h->max_ops < h->min_O ? h->min_O : h->max_ops);
    int32_t R = next_pow2(h->max_units < h->min_R ? h->min_R : h->max_units);
    if (R < 2)
        R = 2;
    int32_t Lq = next_pow2(h->max_q < h->min_Lq ? h->min_Lq : h->max_q);
    if (Lq < 2)
        Lq = 2;
    size_t tu = (size_t)h->total_units, no_ = (size_t)n * O, nq = (size_t)n * Lq;
    /* malloc(0) may give NULL: every buffer gets a byte at least */
    int8_t *po = malloc(no_ + 1);
    int32_t *pc = malloc(4 * no_ + 1);
    uint8_t *pq = malloc(nq + 1);
    int8_t *restrict uo = malloc(tu + 1);
    int32_t *restrict uc = malloc(4 * tu + 1);
    int32_t *restrict ur = malloc(4 * tu + 1);
    if (!po || !pc || !pq || !uo || !uc || !ur) {
        free(po);
        free(pc);
        free(pq);
        free(uo);
        free(uc);
        free(ur);
        snprintf(h->err, sizeof h->err, "out of memory");
        return -2;
    }
    memset(po, CODE_NONE, n * O);
    memset(pc, 0, n * O * 4);
    memset(pq, 0, n * Lq);
    const int8_t *fo = (const int8_t *)h->rec[B_FOPS].p;
    const int32_t *fc = (const int32_t *)h->rec[B_FCOUNTS].p;
    const int32_t *nops = (const int32_t *)h->rec[B_NOPS].p;
    const int32_t *spans = (const int32_t *)h->rec[B_SPANS].p;
    const uint8_t *arena = h->rec[B_ARENA].p;
    size_t cur = 0, u = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t no = nops[i];
        memcpy(po + i * O, fo + cur, no);
        memcpy(pc + i * O, fc + cur, no * 4);
        for (int32_t k = 0; k < no; ++k) {
            int8_t op = fo[cur + k];
            int32_t cnt = fc[cur + k];
            if (is_ref_op(op)) {
                memset(uo + u, op, cnt);
                for (int32_t j = 0; j < cnt; ++j) {
                    uc[u + j] = 1;
                    ur[u + j] = (int32_t)i;
                }
                u += cnt;
            } else {
                uo[u] = op;
                uc[u] = cnt;
                ur[u] = (int32_t)i;
                ++u;
            }
        }
        cur += no;
        /* the staged query: SEQ dna5-normalised, as parse_stage_batch
           stages it (its letters are base16's: ACGT kept, the rest N) */
        const uint8_t *s = arena + spans[i * 8 + 2];
        uint8_t *q = pq + i * Lq;
        for (int32_t k = 0, sl = spans[i * 8 + 3]; k < sl; ++k) {
            uint8_t ch = s[k];
            q[k] = (ch == 'A' || ch == 'C' || ch == 'G' || ch == 'T') ? ch : 'N';
        }
    }
    static const int order[7] = {B_ARENA, B_SPANS, B_LINE, B_FIELDS, B_NOPS,
                                 B_REFUNITS, B_UNITS};
    for (int k = 0; k < 7; ++k) {
        h->last_len[order[k]] = h->rec[order[k]].len;
        ptr[k] = own(&h->rec[order[k]], &len[k]);
    }
    ptr[7] = po;
    len[7] = n * O;
    ptr[8] = pc;
    len[8] = n * O * 4;
    ptr[9] = pq;
    len[9] = n * Lq;
    ptr[10] = uo;
    len[10] = (int64_t)tu;
    ptr[11] = uc;
    len[11] = (int64_t)tu * 4;
    ptr[12] = ur;
    len[12] = (int64_t)tu * 4;
    info[0] = h->n_records;
    info[1] = n;
    info[2] = h->c_flags;
    info[3] = h->c_ref_missing;
    info[4] = h->c_seq_missing;
    info[5] = O;
    info[6] = R;
    info[7] = Lq;
    /* the next batch starts at this one's sizes */
    h->rec[B_FOPS].len = h->rec[B_FCOUNTS].len = 0;
    for (int k = 0; k < 7; ++k)
        if (reserve(&h->rec[order[k]], h->last_len[order[k]]) < 0) {
            for (int j = 0; j < N_OUT; ++j)
                free(ptr[j]);
            snprintf(h->err, sizeof h->err, "out of memory");
            return -2;
        }
    reset_batch(h);
    return 1;
}

/* The next batch: 1 with its buffers (finish_batch), 0 when more input
   is wanted (feed it, or pass eof), 2 at the end of the input, -1 on an
   error in the input and -2 out of memory, with bi_error's message.  The
   batch ends after its batch_size-th kept record, or with the input.  The
   next step inflates while the caller takes the batch and reads. */
int bi_next(bi_state *h, int eof, int64_t *info, void **ptr, int64_t *len)
{
    for (;;) {
        if (!eof && h->comp.len < READ_AHEAD && !h->pending_err)
            return 0;
        while (h->plain_pos + 4 <= h->plain.len) {
            uint32_t size = le32(h->plain.p + h->plain_pos);
            if (h->plain_pos + 4 + (size_t)size > h->plain.len)
                break;
            int rc = take_record(h, h->plain.p + h->plain_pos + 4, size);
            if (rc < 0)
                return rc;
            h->plain_pos += 4 + (size_t)size;
            if (h->kept == h->batch_size) {
                if (step_launch(h) < 0)
                    return -2;
                return finish_batch(h, info, ptr, len);
            }
        }
        if (h->step.active) {
            int rc = step_join(h);
            if (rc < 0)
                return rc;
            if (step_launch(h) < 0)
                return -2;
            continue;
        }
        if (h->pending_err)
            return -1;
        if (step_launch(h) < 0)
            return -2;
        if (h->step.active)
            continue;
        if (!eof)
            return 0;
        if (h->comp.len) {
            snprintf(h->err, sizeof h->err, "truncated BGZF block at EOF");
            return -1;
        }
        if (h->plain_pos < h->plain.len) {
            snprintf(h->err, sizeof h->err, "truncated BAM record at EOF");
            return -1;
        }
        if (h->n_records)
            return finish_batch(h, info, ptr, len);
        return 2;
    }
}
