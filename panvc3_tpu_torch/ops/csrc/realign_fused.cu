// Fused realignment DP for Hopper: affine-gap global alignment (Gotoh),
// fill AND traceback in one launch, in the three scoring modes of the TPU
// kernel: integer (match 0, mismatch -1), pinned-quality Malde, and
// explicit substitution scores.
//
// Replaces panvc3_tpu/ops/realign_pallas_fused.py::_kernel (launched by
// realign_fused_pallas).  Output is byte-identical: ops int8[B, R+Q] holds
// the traceback's op codes in reverse (= 7, X 8, I 1, D 2) followed by 127
// filler, count int32[B] the number of ops.  The recurrences, the 4-bit
// trace cell (bits 0-1 the move: 0 diag match, 3 diag mismatch, 1 vert,
// 2 horiz; bit 2 vopen; bit 3 hopen) and the tie order (diag >= vert >
// horiz, open >= extend) are the Pallas kernel's.  The diagonal's =/X code
// is the byte compare in every mode; only the score depends on the mode:
//   realign_fused_int   eq ? 0 : -1
//   realign_fused_qual  eq ? mrow[qq[b, i-1]] : xrow[qq[b, i-1]]  (the two
//                       64-entry Malde rows at the pinned reference
//                       quality; a phred outside 0..63 scores 0, as the
//                       TPU kernel's one-hot decode does)
//   realign_fused_sub   sub[b, i-1, j-1]  (any R, Q: the tile lives in
//                       global memory, not in a TPU's VMEM)
// One template on the scoring mode holds the fill and the traceback.
//
// Design.  One thread per run.  Each thread walks only its own m x n cells
// and its own <= m+n traceback steps, so a window sorted by length pays no
// tile maximum.  Within a row the horizontal gap uses the sequential
// recurrence h[c] = max(a[c-1] + go + ge, h[c-1] + ge), equal to the TPU
// kernel's prefix max because every score is an integer held exactly in
// f32 (Malde scores in 1/256 units, exact while R+Q <= 5461); compile with
// -fmad=false so no product is fused into an add.  The previous DP row
// (best, vert: f32) and the nibble-packed trace live in global scratch
// laid out [column or word][run], so the 32 threads of a warp touch 32
// consecutive words.  The quality mode reads its two row scores once per
// DP row; the substitution mode reads its tile row by row, each thread
// along its own contiguous row (uncoalesced across the warp, served from
// L1/L2).
//
// What bounds it on the H100.  Not bandwidth: a 48x48 run moves ~18 KB of
// scratch, mostly L1/L2 hits, and 16384 runs of trace (~22 MB) fit in the
// 50 MB L2.  The bound is latency: each cell is a chain of ~10 dependent
// f32 operations, and an aggregate window of 16384 runs puts only ~4 warps
// on each of the 132 SMs, too few to hide that chain.  Later work can give
// each run a warp (anti-diagonal wavefront) to raise the parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 64;

enum Scoring { INT_SCORES, QUAL_SCORES, SUB_SCORES };

template <int MODE>
__global__ void __launch_bounds__(THREADS) realign_fused_kernel(
    const uint8_t* __restrict__ ref,     // [B, R]
    const uint8_t* __restrict__ query,   // [B, Q]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    const int32_t* __restrict__ qq,      // [B, Q] query phreds (QUAL)
    const float* __restrict__ mrow,      // [64] match scores (QUAL)
    const float* __restrict__ xrow,      // [64] mismatch scores (QUAL)
    const float* __restrict__ sub,       // [B, Q, R] (SUB)
    float go, float ge, int B, int R, int Q,
    float* __restrict__ best,            // [R+1, B] scratch
    float* __restrict__ vert,            // [R+1, B] scratch
    uint32_t* __restrict__ trace,        // [(Q+1) * n_words, B] scratch
    int8_t* __restrict__ ops,            // [B, R+Q]
    int32_t* __restrict__ count)         // [B]
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int m = min(max(qlen[b], 0), Q);
    const int n = min(max(rlen[b], 0), R);
    const int n_words = (R + 1 + 7) >> 3;
    const size_t sb = (size_t)B;
    const uint8_t* rrow = ref + (size_t)b * R;
    const uint8_t* qrow = query + (size_t)b * Q;

    // -- row 0: best = go + ge*c (0 at c = 0), vert = NEG; trace col 0 = 0,
    //    the others horiz, with hopen on col 1
    best[b] = 0.0f;
    vert[b] = NEG;
    uint32_t word = 0u;
    for (int c = 1; c <= n; ++c) {
        best[(size_t)c * sb + b] = go + ge * (float)c;
        vert[(size_t)c * sb + b] = NEG;
        word |= (2u | (c == 1 ? 8u : 0u)) << (4 * (c & 7));
        if ((c & 7) == 7) {
            trace[(size_t)(c >> 3) * sb + b] = word;
            word = 0u;
        }
    }
    if ((n & 7) != 7) trace[(size_t)(n >> 3) * sb + b] = word;

    // the hopen bit of column 0 compares two NEG sentinels, as the TPU
    // kernel does (it is never read: column 0 always moves vertically)
    const uint32_t hopen0 = (NEG + go >= NEG) ? 8u : 0u;

    // -- fill rows 1..m
    for (int i = 1; i <= m; ++i) {
        const uint8_t qch = qrow[i - 1];
        // the row's match / mismatch scores (QUAL, INT) or score row (SUB)
        float sm = 0.0f;
        float sx = -1.0f;
        if (MODE == QUAL_SCORES) {
            const int p = qq[(size_t)b * Q + i - 1];
            const bool ok = p >= 0 && p < 64;
            sm = ok ? mrow[p] : 0.0f;
            sx = ok ? xrow[p] : 0.0f;
        }
        const float* srow = MODE == SUB_SCORES ? sub + ((size_t)b * Q + i - 1) * R : nullptr;
        const float border = go + ge * (float)i;
        const float bp0 = best[b];
        const float vp0 = vert[b];
        const bool vopen0 = (bp0 + go + ge) >= (vp0 + ge);
        // column 0: a = vert = border, horiz = NEG, the move forced vert
        best[b] = border;
        vert[b] = border;
        word = 1u | (vopen0 ? 4u : 0u) | hopen0;

        float diag_src = bp0;  // best of the previous row, column c-1
        float a_prev = border; // a of this row, column c-1
        float h_prev = NEG;    // horiz of this row, column c-1
        float b_prev = border; // best of this row, column c-1
        const size_t row_base = (size_t)i * n_words;
        for (int c = 1; c <= n; ++c) {
            const size_t at = (size_t)c * sb + b;
            const float bpc = best[at];
            const float vpc = vert[at];
            const float v_open = bpc + go + ge;
            const float v_ext = vpc + ge;
            const bool vopen = v_open >= v_ext;
            const float vv = fmaxf(v_open, v_ext);
            const bool eq = rrow[c - 1] == qch;
            const float s = MODE == SUB_SCORES ? srow[c - 1] : (eq ? sm : sx);
            const float diag = diag_src + s;
            const float a = fmaxf(diag, vv);
            const float h = fmaxf(a_prev + go + ge, h_prev + ge);
            const bool hopen = b_prev + go >= h_prev;
            uint32_t tr = diag >= vv ? (eq ? 0u : 3u) : 1u;
            if (h > a) tr = 2u;
            const float bc = fmaxf(a, h);
            best[at] = bc;
            vert[at] = vv;
            word |= (tr | (vopen ? 4u : 0u) | (hopen ? 8u : 0u)) << (4 * (c & 7));
            if ((c & 7) == 7) {
                trace[(row_base + (c >> 3)) * sb + b] = word;
                word = 0u;
            }
            diag_src = bpc;
            a_prev = a;
            h_prev = h;
            b_prev = bc;
        }
        if ((n & 7) != 7) trace[(row_base + (n >> 3)) * sb + b] = word;
    }

    // -- traceback from (m, n): at most m+n steps, ops emitted in reverse
    int8_t* orow = ops + (size_t)b * (R + Q);
    int i = m, j = n, state = 0, k = 0;
    while (k < m + n && !(i == 0 && j == 0)) {
        const uint32_t w = trace[((size_t)i * n_words + (j >> 3)) * sb + b];
        const uint32_t cell = (w >> (4 * (j & 7))) & 15u;
        int eff = state == 0 ? (int)(cell & 3u) : state;
        if (state == 0 && i == 0 && j > 0) eff = 2;
        if (state == 0 && j == 0 && i > 0) eff = 1;
        int8_t op;
        if (eff == 0 || eff == 3) {
            op = eff == 0 ? 7 : 8;
            --i;
            --j;
            state = 0;
        } else if (eff == 1) {
            op = 1;
            --i;
            state = (cell >> 2) & 1u ? 0 : 1;
        } else {
            op = 2;
            --j;
            state = (cell >> 3) & 1u ? 0 : 2;
        }
        orow[k++] = op;
    }
    count[b] = k;
    for (int s = k; s < R + Q; ++s) orow[s] = 127;
}

template <int MODE>
int launch(const void* ref, const void* query, const void* qlen, const void* rlen,
           const void* qq, const void* mrow, const void* xrow, const void* sub,
           float go, float ge, int B, int R, int Q,
           void* best, void* vert, void* trace, void* ops, void* count,
           void* stream)
{
    if (B > 0) {
        const int blocks = (B + THREADS - 1) / THREADS;
        realign_fused_kernel<MODE><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)ref, (const uint8_t*)query,
            (const int32_t*)qlen, (const int32_t*)rlen,
            (const int32_t*)qq, (const float*)mrow, (const float*)xrow,
            (const float*)sub, go, ge, B, R, Q,
            (float*)best, (float*)vert, (uint32_t*)trace,
            (int8_t*)ops, (int32_t*)count);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns cudaGetLastError(); the caller allocates every buffer.
extern "C" int realign_fused_int(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    float go, float ge, int B, int R, int Q,
    void* best, void* vert, void* trace, void* ops, void* count,
    void* stream)
{
    return launch<INT_SCORES>(ref, query, qlen, rlen, nullptr, nullptr, nullptr,
                              nullptr, go, ge, B, R, Q, best, vert, trace, ops,
                              count, stream);
}

extern "C" int realign_fused_qual(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    const void* qq, const void* mrow, const void* xrow,
    float go, float ge, int B, int R, int Q,
    void* best, void* vert, void* trace, void* ops, void* count,
    void* stream)
{
    return launch<QUAL_SCORES>(ref, query, qlen, rlen, qq, mrow, xrow, nullptr,
                               go, ge, B, R, Q, best, vert, trace, ops, count,
                               stream);
}

extern "C" int realign_fused_sub(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    const void* sub, float go, float ge, int B, int R, int Q,
    void* best, void* vert, void* trace, void* ops, void* count,
    void* stream)
{
    return launch<SUB_SCORES>(ref, query, qlen, rlen, nullptr, nullptr, nullptr,
                              sub, go, ge, B, R, Q, best, vert, trace, ops,
                              count, stream);
}
