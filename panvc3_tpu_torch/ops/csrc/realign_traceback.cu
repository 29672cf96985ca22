// Traceback of the split route for Hopper: walks the trace that the DP
// fill (realign_fill.cu) wrote and emits each run's alignment ops.
//
// Replaces panvc3_tpu/ops/realign_batch.py::_traceback_batch, an XLA
// lax.scan of R+Q steps over the batch (not a Pallas kernel), which XLA
// compiles into one loop; its plain PyTorch copy
// (panvc3_tpu_torch/ops/realign_batch.py::_traceback_batch) issues a few
// dozen small launches per step instead.  Output is byte-identical to both
// in every element:
//   ops   int8[B, R+Q]: ops[b, s] is the op emitted at step s of run b's
//         walk from (m, n) towards (0, 0), in walk order (the CIGAR
//         reversed): = 7, X 8, I 1, D 2; every step from the first one
//         that finds the walk at (0, 0) emits the 127 filler;
//   count int32[B]: the steps before that one (R+Q if the walk never gets
//         there).
// Inputs: trace uint8[B, Q+1, R+1] (bits 0-1 the move: 0 diag, 1 vert, 2
// horiz; bit 2 vopen; bit 3 hopen), ref uint8[B, R], query uint8[B, Q],
// qlen (m) and rlen (n) int32[B], with 0 <= m <= Q and 0 <= n <= R on the
// split route.
//
// Each step is the scan's, compare for compare: done is (i, j) == (0, 0);
// the cell at (i, j) is read through the flat index i*(R+1) + j, and a
// flat index outside the run's trace reads 0, as the scan's one-hot sum
// does; in the match state (0) the move is the cell's, horiz on row 0 and
// vert on column 0, and in a gap state (1 vert, 2 horiz) the state itself;
// a diagonal step emits = where query[i-1] equals ref[j-1] (a byte outside
// its row reads 0), else X; the next state is 0 after a diagonal step, and
// after a vertical or horizontal one 0 where the cell's vopen or hopen bit
// is set (the gap opened here), else the gap's own state.  A move of 3,
// which the fill never writes, emits D and stays put, as the scan does.
// Once the walk is at (0, 0) the scan keeps stepping but changes nothing
// (i, j, state and count stay), so the thread stops there and writes the
// filler to the rest of its row.
//
// Design.  One thread per run: the walk is serial within a run, and the
// split route's window holds 16384 runs.  Its state (i, j, the gap state,
// the step) stays in registers.  A step reads one trace byte, and a
// diagonal step one query and one reference byte, through the read-only
// data cache, and stores one op byte.  The fill has just written the trace
// on the same stream, so at the window (39.3 MB of trace) most of it is
// still in the 50 MB L2.
//
// Bound on the H100 (SXM, 700 W).  On 16384 full 48x48 runs of random
// bases the walks take ~64 steps each (a diagonal step covers a row and a
// column at once).  Their ~20 integer operations a step (the cell's
// decode, the move, the op and the update) come to 1.26 us at 16.75 T
// op/s, above the 3.9 MB of those bytes, the runs' lengths and every
// output byte (1.15 us at 3.35 TB/s), so operations set the bound
// (chip_smoke.py computes it from the inputs it times).  The kernel
// reaches under 2% of it there on an H100 80GB HBM3 at 700 W (PERF.md).
// What limits this design is neither: each step's address depends on the
// cell the step before read, so a thread waits out one L2 round trip per
// step, and a window puts only ~4 warps on each SM to hide them.  At
// ~1.2 ms per chromosome-scale call that is left as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // runs per block: 256 blocks for a 16384-run window
constexpr int DIAG = 0, VERT = 1, HORIZ = 2;
constexpr int8_t OP_EQ = 7, OP_X = 8, OP_I = 1, OP_D = 2, FILLER = 127;

__global__ void __launch_bounds__(THREADS) realign_traceback_kernel(
    const uint8_t* __restrict__ trace,   // [B, Q+1, R+1]
    const uint8_t* __restrict__ ref,     // [B, R]
    const uint8_t* __restrict__ query,   // [B, Q]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    int B, int R, int Q,
    int8_t* __restrict__ ops,            // [B, R+Q]
    int32_t* __restrict__ count)         // [B]
{
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const int W = R + 1;
    const long long cells = (long long)(Q + 1) * W;
    const uint8_t* tr = trace + (size_t)b * (size_t)cells;
    const uint8_t* rrow = ref + (size_t)b * R;
    const uint8_t* qrow = query + (size_t)b * Q;
    int8_t* orow = ops + (size_t)b * (R + Q);
    const int steps = R + Q;

    int i = qlen[b], j = rlen[b], state = 0, s = 0;
    for (; s < steps && !(i == 0 && j == 0); ++s) {
        const long long idx = (long long)i * W + j;
        const int cell = idx >= 0 && idx < cells ? (int)__ldg(tr + idx) : 0;
        const int move = cell & 3;
        const int vopen = (cell >> 2) & 1;
        const int hopen = (cell >> 3) & 1;

        const bool in_m = state == 0;
        int eff = in_m ? move : state;
        if (in_m && i == 0 && j > 0) eff = HORIZ;
        if (in_m && j == 0 && i > 0) eff = VERT;
        const bool is_diag = eff == DIAG;
        const bool is_vert = eff == VERT;
        const bool is_horiz = eff == HORIZ;

        int8_t op;
        if (is_diag) {
            const int qc = i >= 1 && i <= Q ? (int)__ldg(qrow + i - 1) : 0;
            const int rc = j >= 1 && j <= R ? (int)__ldg(rrow + j - 1) : 0;
            op = qc == rc ? OP_EQ : OP_X;
        } else {
            op = is_vert ? OP_I : OP_D;
        }
        orow[s] = op;

        const int ni = is_diag || is_vert ? i - 1 : i;
        const int nj = is_diag || is_horiz ? j - 1 : j;
        state = is_diag ? 0 : is_vert ? (vopen ? 0 : VERT) : (hopen ? 0 : HORIZ);
        i = ni;
        j = nj;
    }
    count[b] = s;
    for (int r = s; r < steps; ++r) orow[r] = FILLER;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns cudaGetLastError(); the caller allocates every buffer.
extern "C" int realign_traceback(
    const void* trace, const void* ref, const void* query,
    const void* qlen, const void* rlen, int B, int R, int Q,
    void* ops, void* count, void* stream)
{
    if (B <= 0) return (int)cudaGetLastError();
    const int blocks = (B + THREADS - 1) / THREADS;
    realign_traceback_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)trace, (const uint8_t*)ref, (const uint8_t*)query,
        (const int32_t*)qlen, (const int32_t*)rlen, B, R, Q,
        (int8_t*)ops, (int32_t*)count);
    return (int)cudaGetLastError();
}
