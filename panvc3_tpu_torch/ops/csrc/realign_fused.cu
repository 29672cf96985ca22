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
//   realign_fused_sub   sub[b, i-1, j-1]  (any R, Q)
// One template on the scoring mode holds the fill and the traceback.
// Within a row the horizontal gap uses the sequential recurrence
// h[c] = max(a[c-1] + go + ge, h[c-1] + ge), equal to the TPU kernel's
// prefix max because every score is an integer held exactly in f32 (Malde
// scores in 1/256 units, exact while R+Q <= 5461); compile with
// -fmad=false so no product is fused into an add.
//
// Bound on the H100 (SXM, 700 W).  A DP cell needs 12 f32 operations (the
// 9 adds and maxes of the recurrence and the compares that make the trace
// bits), issued unfused at 33.5 T op/s, half the published 67 TFLOP/s,
// which counts an FMA as two.  16384 full 48x48 runs (37.7 M cells) are
// 13.5 us of operations; their bytes (1.7 MB in, 4.8 MB with the quality
// mode's phreds, and 1.6 MB out, at 3.35 TB/s) take 1-2 us, so operations
// set the bound.  The substitution mode reads a 4-byte score per cell it
// needs (rows 1..m, columns 1..n of each run), so bytes set its bound.
//
// What set the previous design's time (one thread per run, the previous
// DP row in global scratch): ~0.24 ms per 16384x48x48 window, ~5% of the
// bound.  An aggregate window put ~4 warps on each SM, every cell a chain
// of ~10 dependent operations plus a 16-byte load and store of the row
// above through L1/L2, with no other warps to hide either; at 2048 runs
// 100 of the 132 SMs had no block at all.
//
// This design.  A group of G lanes aligns one run, so a warp holds 32/G
// runs.  Lane t of the group owns ROWS consecutive query rows and keeps
// their a / h / best in registers; the group sweeps the columns as a
// wavefront, lane t on column s - t + 1 at step s.  Each step the last
// row's best and vert pass to lane t+1 by __shfl_up_sync; the diagonal is
// what the lane received the step before.  Lane 0 makes row 0 inline
// (go + ge*c, NEG).  Where m > G*ROWS, strips of G*ROWS rows follow one
// another and the last row of a strip hands over to the next through a
// ping-pong row buffer beside the run's trace.  Each lane shifts its rows'
// trace nibbles into a register word and stores one 32-bit word per row
// and 8 columns into the run's [row][word] trace tile in shared memory
// (1.4 KB for 48x48, 8.8 KB for 128x128).  Where a block's tiles do not fit
// in shared memory (the substitution mode takes any R, Q), every tile and
// row buffer of the launch lives in global scratch laid out [word][run]
// instead: a choice of memory, not of result.  After the fill one lane of
// the group walks the traceback (at most m+n steps) and the group writes
// the 127 filler.  Each cell reads the same three neighbours and evaluates
// every expression and compare of the one-thread-per-run kernel term by
// term; only the schedule differs.  Every warp loops to a warp-uniform step
// count so that each __shfl_*_sync has all 32 lanes, finished groups
// predicated off.
//
// (G, ROWS) follow the query bucket: 4x12 for Q <= 48 (16x3 in the
// substitution mode), 16x8 for Q <= 128, 32x8 above.  A 16384-run window
// at Q 48 is 2048 warps: one wave of 16 resident warps on most SMs.  4x12
// measured 21% faster there than 8x6 (31 warps per SM), and 16x8 was the
// fastest of 8x16, 16x8 and 32x4 at 2048 runs of 128x128.  Occupancy does
// not bound it (64 registers, and with them 32 warps per SM, moved it by
// 2%): instruction issue does.  Each cell costs ~25 instructions, ~17 of
// them compares, min/max, selects and logic, which Hopper issues at half
// the FP32 add rate; about half of all instructions build the trace
// nibble.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
// Hopper: the most dynamic shared memory one block may opt in to
constexpr size_t SMEM_LIMIT = 232448;

enum Scoring { INT_SCORES, QUAL_SCORES, SUB_SCORES };

// (G, ROWS) by scoring mode and query bucket (Q <= 48, <= 128, above).
// The substitution mode reads a 4-byte score per cell from global memory:
// at Q <= 48 it takes 3 rows per lane, so that the rows a warp reads at
// once stay in L1 (measured 3x faster than 4x12 at 16384 runs of 48x48).
constexpr int GROUP[3][3] = {{4, 16, 32}, {4, 16, 32}, {16, 16, 32}};
constexpr int ROWS_PER_LANE[3][3] = {{12, 8, 8}, {12, 8, 8}, {3, 8, 8}};

int bucket(int Q) { return Q <= 48 ? 0 : (Q <= 128 ? 1 : 2); }

struct Plan {
    int group;              // G: lanes per run
    int rows;               // ROWS: query rows per lane and strip
    int runs_per_block;
    size_t trace_words;     // (Q+1) * n_words
    size_t slice_words;     // trace tile + hand-over row buffers, per run
    bool smem;              // tiles in shared memory (else global scratch)
};

Plan make_plan(int R, int Q, int mode)
{
    Plan p;
    p.group = GROUP[mode][bucket(Q)];
    p.rows = ROWS_PER_LANE[mode][bucket(Q)];
    p.runs_per_block = THREADS / p.group;
    const size_t n_words = (size_t)(R + 1 + 7) / 8;
    p.trace_words = (size_t)(Q + 1) * n_words;
    // two buffers (ping-pong) of best and vert over columns 0..R
    const size_t hand_words = Q > p.group * p.rows ? 4 * (size_t)(R + 1) : 0;
    p.slice_words = p.trace_words + hand_words;
    p.smem = p.slice_words * 4 * p.runs_per_block <= SMEM_LIMIT;
    return p;
}

// The integer and quality instances are capped at 128 registers, so that
// a block of the 48x48 window keeps 16 warps on each SM (the quality
// instance measured 11% faster so; left to itself it takes 145).  The cap
// slows the substitution instance, which goes uncapped.
template <int MODE, int G, int ROWS>
__global__ void __launch_bounds__(THREADS, MODE == SUB_SCORES ? 1 : 4) realign_fused_kernel(
    const uint8_t* __restrict__ ref,     // [B, R]
    const uint8_t* __restrict__ query,   // [B, Q]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    const int32_t* __restrict__ qq,      // [B, Q] query phreds (QUAL)
    const float* __restrict__ mrow,      // [64] match scores (QUAL)
    const float* __restrict__ xrow,      // [64] mismatch scores (QUAL)
    const float* __restrict__ sub,       // [B, Q, R] (SUB)
    float go, float ge, int B, int R, int Q,
    uint32_t* __restrict__ scratch,      // [slice_words, B] unless smem
    int trace_words, int slice_words, bool smem,
    int8_t* __restrict__ ops,            // [B, R+Q]
    int32_t* __restrict__ count)         // [B]
{
    extern __shared__ uint32_t tiles[];
    const int t = (threadIdx.x & 31) % G;    // lane within the group
    const int slot = threadIdx.x / G;        // run within the block
    const int b = blockIdx.x * (THREADS / G) + slot;
    const bool valid = b < B;
    const int m = valid ? min(max(qlen[b], 0), Q) : 0;
    const int n = valid ? min(max(rlen[b], 0), R) : 0;
    const int n_words = (R + 1 + 7) >> 3;
    const uint8_t* rrow = ref + (size_t)b * R;
    const uint8_t* qrow = query + (size_t)b * Q;

    // the run's trace tile ([row][word]) and hand-over rows: a slice of
    // shared memory (stride 1) or a column of global scratch (stride B)
    uint32_t* tr;
    size_t S;
    if (smem) {
        tr = tiles + (size_t)slot * slice_words;
        S = 1;
    } else {
        tr = scratch + b;
        S = (size_t)B;
    }
    float* hand = reinterpret_cast<float*>(tr + (size_t)trace_words * S);
    // hand-over buffer p, array a (0 best, 1 vert), column c
    auto hand_at = [&](int p, int a, int c) -> float& {
        return hand[((size_t)(2 * p + a) * (R + 1) + c) * S];
    };

    // -- row 0: trace col 0 = 0, the others horiz, with hopen on col 1
    if (valid) {
        for (int w = t; w <= (n >> 3); w += G) {
            uint32_t word = 0u;
            for (int k = 0; k < 8; ++k) {
                const int c = 8 * w + k;
                if (c >= 1 && c <= n) word |= (2u | (c == 1 ? 8u : 0u)) << (4 * k);
            }
            tr[(size_t)w * S] = word;
        }
    }

    // the hopen bit of column 0 compares two NEG sentinels, as the TPU
    // kernel does (it is never read: column 0 always moves vertically)
    const uint32_t hopen0 = (NEG + go >= NEG) ? 8u : 0u;

    // -- fill rows 1..m, one strip of G*ROWS rows at a time; the warp's
    //    groups all loop to the warp's largest strip and step counts
    const int span = G * ROWS;
    const int strips = __reduce_max_sync(FULL, (m + span - 1) / span);
    const int steps = __reduce_max_sync(FULL, n) + G - 1;
    for (int k = 0; k < strips; ++k) {
        const int i0 = k * span + t * ROWS + 1;  // this lane's first row
        const bool lane_live = i0 <= m;
        const int rd = (k + 1) & 1;              // buffer strip k-1 wrote
        const int wr = k & 1;                    // buffer for strip k+1
        const bool hand_on = (k + 1) * span < m;
        float a_prev[ROWS], h_prev[ROWS], b_prev[ROWS];
        float sm[ROWS], sx[ROWS];
        uint32_t word[ROWS];
        uint8_t qch[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int i = i0 + r;
            const bool live = i <= m;
            qch[r] = live ? qrow[i - 1] : 0;
            sm[r] = 0.0f;
            sx[r] = -1.0f;
            if (MODE == QUAL_SCORES) {
                const int p = live ? qq[(size_t)b * Q + i - 1] : -1;
                const bool ok = p >= 0 && p < 64;
                sm[r] = ok ? mrow[p] : 0.0f;
                sx[r] = ok ? xrow[p] : 0.0f;
            }
            // column 0: a = vert = border, horiz = NEG, the move forced
            // vert; vopen compares the row above's column 0 (best 0 and
            // vert NEG in row 0, border in the rows below)
            const float border = go + ge * (float)i;
            const float bp0 = i == 1 ? 0.0f : go + ge * (float)(i - 1);
            const float vp0 = i == 1 ? NEG : bp0;
            const bool vopen0 = (bp0 + go + ge) >= (vp0 + ge);
            a_prev[r] = border;
            h_prev[r] = NEG;
            b_prev[r] = border;
            word[r] = (1u | (vopen0 ? 4u : 0u) | hopen0) << 28;
            if (n == 0 && live) tr[(size_t)i * n_words * S] = word[r] >> 28;
        }
        // best of the row above at column c-1 (starts at column 0)
        float diag_top = i0 == 1 ? 0.0f : go + ge * (float)(i0 - 1);
        float out_best = 0.0f, out_vert = 0.0f;  // last row, last column
        for (int s = 0; s < steps; ++s) {
            const float in_best = __shfl_up_sync(FULL, out_best, 1, G);
            const float in_vert = __shfl_up_sync(FULL, out_vert, 1, G);
            const int c = s - t + 1;
            if (!lane_live || c < 1 || c > n) continue;
            // the row above at column c: lane t-1's last row, row 0, or
            // the previous strip's last row
            float ub, uv;
            if (t > 0) {
                ub = in_best;
                uv = in_vert;
            } else if (k == 0) {
                ub = go + ge * (float)c;
                uv = NEG;
            } else {
                ub = hand_at(rd, 0, c);
                uv = hand_at(rd, 1, c);
            }
            float ud = diag_top;
            diag_top = ub;
            const uint8_t rch = rrow[c - 1];
            float ss[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                if (MODE == SUB_SCORES) {
                    const int i = i0 + r;
                    ss[r] = i <= m ? sub[((size_t)b * Q + i - 1) * R + c - 1] : 0.0f;
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float v_open = ub + go + ge;
                const float v_ext = uv + ge;
                const bool vopen = v_open >= v_ext;
                const float vv = fmaxf(v_open, v_ext);
                const bool eq = rch == qch[r];
                const float sc = MODE == SUB_SCORES ? ss[r] : (eq ? sm[r] : sx[r]);
                const float diag = ud + sc;
                const float a = fmaxf(diag, vv);
                const float h = fmaxf(a_prev[r] + go + ge, h_prev[r] + ge);
                const bool hopen = b_prev[r] + go >= h_prev[r];
                uint32_t mv = diag >= vv ? (eq ? 0u : 3u) : 1u;
                if (h > a) mv = 2u;
                const float bc = fmaxf(a, h);
                // shift the nibble in from the top: after 8 columns the
                // word holds them in column order, column 8w in bits 0-3
                word[r] = __funnelshift_r(word[r], mv | (vopen ? 4u : 0u) | (hopen ? 8u : 0u), 4);
                ud = b_prev[r];  // best of this row at c-1: the next row's diagonal
                ub = bc;
                uv = vv;
                a_prev[r] = a;
                h_prev[r] = h;
                b_prev[r] = bc;
            }
            if ((c & 7) == 7 || c == n) {
                // a word cut short at column n moves down to bit 0
                const int sh = 4 * (7 - (c & 7));
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const int i = i0 + r;
                    if (i <= m) tr[((size_t)i * n_words + (c >> 3)) * S] = word[r] >> sh;
                }
            }
            out_best = ub;
            out_vert = uv;
            if (t == G - 1 && hand_on) {
                hand_at(wr, 0, c) = ub;
                hand_at(wr, 1, c) = uv;
            }
        }
        __syncwarp();
    }
    __syncwarp();

    // -- traceback from (m, n) by the group's lane 0: at most m+n steps,
    //    ops emitted in reverse; then the group writes the filler
    int8_t* orow = ops + (size_t)b * (R + Q);
    int k = 0;
    if (valid && t == 0) {
        int i = m, j = n, state = 0;
        while (k < m + n && !(i == 0 && j == 0)) {
            const uint32_t w = tr[((size_t)i * n_words + (j >> 3)) * S];
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
    }
    k = __shfl_sync(FULL, k, 0, G);
    if (valid) {
        for (int s = k + t; s < R + Q; s += G) orow[s] = 127;
    }
}

template <int MODE, int G, int ROWS>
int launch_planned(const Plan& p, const void* ref, const void* query, const void* qlen,
                   const void* rlen, const void* qq, const void* mrow, const void* xrow,
                   const void* sub, float go, float ge, int B, int R, int Q,
                   void* scratch, void* ops, void* count, void* stream)
{
    auto kern = realign_fused_kernel<MODE, G, ROWS>;
    const size_t smem = p.smem ? p.slice_words * 4 * p.runs_per_block : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (B + p.runs_per_block - 1) / p.runs_per_block;
    kern<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const uint8_t*)query,
        (const int32_t*)qlen, (const int32_t*)rlen,
        (const int32_t*)qq, (const float*)mrow, (const float*)xrow,
        (const float*)sub, go, ge, B, R, Q,
        (uint32_t*)scratch, (int)p.trace_words, (int)p.slice_words, p.smem,
        (int8_t*)ops, (int32_t*)count);
    return (int)cudaGetLastError();
}

template <int MODE>
int launch(const void* ref, const void* query, const void* qlen, const void* rlen,
           const void* qq, const void* mrow, const void* xrow, const void* sub,
           float go, float ge, int B, int R, int Q,
           void* scratch, void* ops, void* count, void* stream)
{
    if (B <= 0) return (int)cudaGetLastError();
    const Plan p = make_plan(R, Q, MODE);
    if (!p.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    switch (bucket(Q)) {
    case 0:
        return launch_planned<MODE, GROUP[MODE][0], ROWS_PER_LANE[MODE][0]>(
            p, ref, query, qlen, rlen, qq, mrow, xrow, sub, go, ge, B, R, Q,
            scratch, ops, count, stream);
    case 1:
        return launch_planned<MODE, GROUP[MODE][1], ROWS_PER_LANE[MODE][1]>(
            p, ref, query, qlen, rlen, qq, mrow, xrow, sub, go, ge, B, R, Q,
            scratch, ops, count, stream);
    default:
        return launch_planned<MODE, GROUP[MODE][2], ROWS_PER_LANE[MODE][2]>(
            p, ref, query, qlen, rlen, qq, mrow, xrow, sub, go, ge, B, R, Q,
            scratch, ops, count, stream);
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// realign_fused_scratch: the int32 words of global scratch per run that a
// launch of scoring mode ``mode`` (0 int, 1 qual, 2 sub) at (R, Q) needs,
// 0 when the tiles fit in shared memory; the caller passes a [words, B]
// buffer as ``scratch`` (else null).
extern "C" int realign_fused_scratch(int R, int Q, int mode)
{
    if (mode < INT_SCORES || mode > SUB_SCORES) return -1;
    const Plan p = make_plan(R, Q, mode);
    return p.smem ? 0 : (int)p.slice_words;
}

// Each kernel entry launches on ``stream`` and returns cudaGetLastError();
// the caller allocates every buffer.
extern "C" int realign_fused_int(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    float go, float ge, int B, int R, int Q,
    void* scratch, void* ops, void* count, void* stream)
{
    return launch<INT_SCORES>(ref, query, qlen, rlen, nullptr, nullptr, nullptr,
                              nullptr, go, ge, B, R, Q, scratch, ops, count, stream);
}

extern "C" int realign_fused_qual(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    const void* qq, const void* mrow, const void* xrow,
    float go, float ge, int B, int R, int Q,
    void* scratch, void* ops, void* count, void* stream)
{
    return launch<QUAL_SCORES>(ref, query, qlen, rlen, qq, mrow, xrow, nullptr,
                               go, ge, B, R, Q, scratch, ops, count, stream);
}

extern "C" int realign_fused_sub(
    const void* ref, const void* query, const void* qlen, const void* rlen,
    const void* sub, float go, float ge, int B, int R, int Q,
    void* scratch, void* ops, void* count, void* stream)
{
    return launch<SUB_SCORES>(ref, query, qlen, rlen, nullptr, nullptr, nullptr,
                              sub, go, ge, B, R, Q, scratch, ops, count, stream);
}
