/* The difference-event tables of one (src, dst) gap-vector pair in one
 * scan of the packed words: the host C counterpart of the NumPy body of
 * ops/event_geometry.py::build_pair_events, which stays the reference.
 *
 * Words are uint32, bit i of word w the column 32*w + i (1 == gap).  Take
 * the columns c < limit (min(src.n, dst.n)) where the rows differ, in
 * column order, and srank(c) = c - (source gaps before c), the number of
 * source units before column c:
 *   source base, destination gap: the unit srank projects onto a gap.
 *           Consecutive ranks form one run [gap_start, gap_end], as
 *           np.r_[True, np.diff(g) > 1] cuts them;
 *   source gap, destination base: one destination base at boundary srank.
 *           Ranks do not decrease along the columns, so equal ranks are
 *           neighbours and (del_b, del_len) is np.unique(d,
 *           return_counts=True) without its sort.
 * The two lists are independent, so each word's differences are split by
 * the source bit and each part walked by runs of set bits, not bit by
 * bit: a run of source bases has consecutive ranks, a run of source gaps
 * one rank.  A run that carries on a list's last entry (the rank after
 * its end, or its boundary) extends it, across words too.  The running
 * count of source gaps is kept per word; within a word the gaps below bit
 * b are one popcount.
 *
 * event_tables_scan fills caller-owned int64 arrays and writes the number
 * of gap runs and deletion boundaries to counts[0..1].  With gap_start
 * NULL it only counts, so a caller counts first, allocates, then fills.
 * It touches no Python object and may run without the interpreter lock.
 */

#include <stddef.h>
#include <stdint.h>

/* The run of set bits that starts at the lowest set bit of x (x != 0):
 * its first bit and its length. */
static inline void lowest_run(uint32_t x, int *first, int *len)
{
    const int b = __builtin_ctz(x);
    const uint32_t rest = ~(x >> b); /* 0 only for a run of all 32 bits */
    *first = b;
    *len = rest ? __builtin_ctz(rest) : 32;
}

static inline uint32_t clear_run(uint32_t x, int first, int len)
{
    return len == 32 ? 0u : x & ~(((1u << len) - 1u) << first);
}

int event_tables_scan(const uint32_t *src, const uint32_t *dst, int64_t n_words,
                      int64_t limit, int64_t *gap_start, int64_t *gap_end,
                      int64_t *del_b, int64_t *del_len, int64_t *counts)
{
    const int fill = gap_start != NULL;
    int64_t n_gap = 0, n_del = 0;
    int64_t last_end = 0, last_b = 0;
    int64_t gaps_before = 0; /* source gaps in words 0..w-1 */
    for (int64_t w = 0; w < n_words; ++w) {
        const int64_t base = w << 5;
        if (base >= limit)
            break;
        const uint32_t s = src[w];
        uint32_t diff = s ^ dst[w];
        if (limit - base < 32)
            diff &= (1u << (limit - base)) - 1u;
        int b, k;
        for (uint32_t g = diff & ~s; g; g = clear_run(g, b, k)) {
            lowest_run(g, &b, &k);
            const int64_t r0 = base + b - gaps_before - __builtin_popcount(s & ((1u << b) - 1u));
            if (n_gap > 0 && r0 == last_end + 1) {
                if (fill)
                    gap_end[n_gap - 1] = r0 + k - 1;
            } else {
                if (fill) {
                    gap_start[n_gap] = r0;
                    gap_end[n_gap] = r0 + k - 1;
                }
                ++n_gap;
            }
            last_end = r0 + k - 1;
        }
        for (uint32_t d = diff & s; d; d = clear_run(d, b, k)) {
            lowest_run(d, &b, &k);
            const int64_t r = base + b - gaps_before - __builtin_popcount(s & ((1u << b) - 1u));
            if (n_del > 0 && r == last_b) {
                if (fill)
                    del_len[n_del - 1] += k;
            } else {
                if (fill) {
                    del_b[n_del] = r;
                    del_len[n_del] = k;
                }
                ++n_del;
                last_b = r;
            }
        }
        gaps_before += __builtin_popcount(s);
    }
    counts[0] = n_gap;
    counts[1] = n_del;
    return 0;
}
