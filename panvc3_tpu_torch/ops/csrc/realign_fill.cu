// Affine-gap DP fill for Hopper from explicit substitution scores: the
// split route's fill (realign_traceback.cu walks the trace after it).
//
// Replaces panvc3_tpu/ops/realign_pallas.py::_fill_kernel (launched by
// fill_batch_pallas), the drop-in for realign_batch._fill_batch.  Output is
// byte-identical to that plain fill in EVERY cell of trace uint8[B, Q+1,
// R+1], not only the cells a traceback reads:
//   - row 0: column 0 is 0, every other column horiz (2), with hopen (8)
//     on column 1;
//   - rows i <= m: move in bits 0-1 (0 diag, match or mismatch alike; 1
//     vert; 2 horiz; column 0 always vert), vopen bit 2, hopen bit 3;
//   - rows past m: 0;
//   - columns past n: what the NEG-sentinel arithmetic of the plain fill
//     gives.  best and vert are masked to NEG there between rows, but the
//     horizontal gap runs on from the row's real values and hopen compares
//     the unmasked best; column 0's hopen compares two NEG sentinels.
// Ties: diag >= vert > horiz, open >= extend.
//
// Design.  One warp per run, lanes across columns, rows in order: the
// plain fill's own schedule (column-parallel, row by row), with the warp
// as the row.  A row of R+1 columns is cut into chunks of 32*COLS columns;
// lane t of chunk k owns columns 32*COLS*k + COLS*t .. + COLS-1 (COLS is 1,
// or 2 where a row fits one 64-column chunk; see make_plan).  For each
// row 1..min(max(m, 0), Q) the warp evaluates, per column, the plain
// fill's expressions term by term: v_open, v_ext, vopen and vert from the
// previous row's best/vert; diag from best[c-1] and the score; a; the
// column-0 border; then the horizontal gap as the plain fill computes it,
// run = the exclusive prefix max of shifted = a + go - ge*c, and horiz =
// run + ge*c.  The prefix max is a max within the lane, a 5-step
// __shfl_up_sync scan across the lanes, and a carry from the chunk before
// that lane 0 folds in; max is exact in any order, so the result is the
// plain fill's cummax bit for bit (every score is an integer exact in f32,
// and the build keeps -fmad=false so no product is fused into an add).
// hopen needs horiz and the unmasked best of column c-1: one rotation of
// each across the warp, whose lane-31 value is the next chunk's carry.
// So a chunk costs 8 shuffles whatever COLS is.  The masks are the plain
// fill's: best/vert past n (the raw n, as it compares) go to NEG before
// they pass to the next row.
//
// Memory.  The previous row's best and vert live in shared memory, ping-
// pong per warp: 16*(R+1) bytes (784 B at R = 48), read and written at
// consecutive addresses.  Where a row takes several chunks (R+1 > 64) the
// warp also stages its score rows in two shared buffers by cp.async, a row
// ahead: row i+1 is in flight while row i is computed (8*R more bytes).
// Where a warp's bytes exceed the 48 KB a block gets without opting in
// (R > 2047), the row state lives in global scratch laid out [run][column]
// and the scores are read straight from global memory: a choice of memory,
// not of result.  The score row is read coalesced (a chunk's lanes read
// 32*COLS consecutive floats) and the trace row stored coalesced (32*COLS
// consecutive bytes); row 0 is stored as the warp's first row, and the
// rows past m, one contiguous block per run, in 16-byte stores where
// aligned.  Warps per block come from R (make_plan).
//
// Bound on the H100 (SXM, 700 W).  The fill reads the score rows 1..m of
// each run at every column and writes the whole trace: at 16384 full
// 48x48 runs that is 151.0 MB of scores and 39.3 MB of trace, 56.9 us at
// 3.35 TB/s, above the 12 f32 operations per cell at 33.5 T op/s, so bytes
// set the bound.  The kernel reaches about a fifth of it there (PERF.md).
// What limits it is not bytes but the work per chunk and row: a chain of
// dependent steps (shared and score loads, the 5-step shuffle scan, two
// rotations, the stores) and the instructions along it, 8 shuffles per
// chunk and row, which Hopper issues at about one warp instruction per
// clock per SM, and ~25 f32 adds, maxes, compares and selects per column.
// Measured on the card against the first cut of this design (one column
// per lane, scores read from global memory): two columns per lane, one
// chunk per 48-column row instead of two, took 27% off the 48x48 window;
// staging the scores took 7% off it and 34% off 2048 runs of 128x128,
// where ~16 warps per SM hide less latency, but on top of two columns per
// lane it cost the window 5%, so it runs only where a row has several
// chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;               // runs per block
constexpr size_t SMEM_BUDGET = 48 * 1024;  // dynamic shared memory without opt-in

// floats of row state per run: two rows (ping-pong) of best and vert
__host__ __device__ size_t state_floats(int R) { return 4 * (size_t)(R + 1); }

// floats of shared memory per warp: the row state and two score rows
__host__ __device__ size_t smem_floats(int R) { return state_floats(R) + 2 * (size_t)R; }

struct Plan {
    int cols;          // columns per lane: a chunk is 32 * cols columns
    int warps;         // runs per block
    bool smem;         // row state in shared memory (else global scratch)
    bool stage;        // score rows staged in shared memory by cp.async
    size_t smem_bytes; // per block
};

// Two columns per lane where a row fits one 64-column chunk.  Score rows
// are staged a row ahead where a row takes several chunks: on top of two
// columns per lane, staging measured 5% slower at 16384 runs of 48x48.
Plan make_plan(int R)
{
    Plan p;
    p.cols = R + 1 <= 64 ? 2 : 1;
    const size_t per_warp = (p.cols == 1 ? smem_floats(R) : state_floats(R)) * sizeof(float);
    p.smem = per_warp <= SMEM_BUDGET;
    p.stage = p.smem && p.cols == 1;
    p.warps = p.smem && SMEM_BUDGET / per_warp < MAX_WARPS ? (int)(SMEM_BUDGET / per_warp)
                                                            : MAX_WARPS;
    p.smem_bytes = p.smem ? per_warp * p.warps : 0;
    return p;
}

// lane t receives lane t-1's v; lane 0 receives lane 31's (the next
// chunk's carry)
__device__ __forceinline__ float rotate_up(float v, int t)
{
    return __shfl_sync(FULL, v, (t + 31) & 31);
}

// cp.async one score row (R floats) from global to shared memory, one
// commit group per lane
__device__ __forceinline__ void stage_row(float* dst, const float* src, int R, int t)
{
    for (int c = t; c < R; c += 32) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + c);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + c) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int COLS>
__global__ void __launch_bounds__(MAX_WARPS * 32) realign_fill_sub_kernel(
    const float* __restrict__ sub,       // [B, Q, R]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    float go, float ge, int B, int R, int Q,
    float* __restrict__ scratch,         // [B, 4*(R+1)], or null: shared memory
    bool stage,                          // score rows staged in shared memory
    uint8_t* __restrict__ trace)         // [B, Q+1, R+1]
{
    extern __shared__ float rows_sh[];
    constexpr int CHUNK = 32 * COLS;
    const int t = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;  // the whole warp
    const int m = qlen[b];
    const int n = rlen[b];
    const int W = R + 1;
    const int chunks = (W + CHUNK - 1) / CHUNK;
    uint8_t* out = trace + (size_t)b * (Q + 1) * W;
    // [buffer 0/1][best, vert][column 0..R], then (stage) [buffer 0/1][R]
    // score rows
    float* state = scratch ? scratch + (size_t)b * state_floats(R)
                           : rows_sh + (size_t)w * (stage ? smem_floats(R) : state_floats(R));
    float* sbuf = state + state_floats(R);
    const float* srun = sub + (size_t)b * Q * R;

    // -- row 0 (buffer 0)
    for (int c = t; c <= R; c += 32) {
        const float b0 = c == 0 ? 0.0f : go + ge * (float)c;
        state[c] = c <= n ? b0 : NEG;
        state[W + c] = NEG;
        out[c] = c == 0 ? 0 : (uint8_t)(2u | (c == 1 ? 8u : 0u));
    }
    __syncwarp();

    // -- rows 1..min(m, Q): row i reads buffer (i-1)&1 and writes i&1
    const int rows = min(max(m, 0), Q);
    if (stage && rows >= 1) stage_row(sbuf + R, srun, R, t);
    for (int i = 1; i <= rows; ++i) {
        const float* bp = state + ((i - 1) & 1) * 2 * W;
        const float* vp = bp + W;
        float* bn = state + (i & 1) * 2 * W;
        float* vn = bn + W;
        // score row i-1: staged in buffer i&1 a row ahead (cp.async), or
        // read from global memory
        const float* srow = srun + (size_t)(i - 1) * R;
        if (stage) {
            if (i < rows) {
                stage_row(sbuf + ((i + 1) & 1) * R, srun + (size_t)i * R, R, t);
                asm volatile("cp.async.wait_group 1;\n" ::: "memory");
            } else {
                asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            }
            __syncwarp();
            srow = sbuf + (i & 1) * R;
        }
        uint8_t* orow = out + (size_t)i * W;
        const float border = go + ge * (float)i;
        // lane 0's carries from the chunk before: the max of NEG and every
        // shifted before it, and horiz and unmasked best of its last column
        float carry_run = NEG, carry_h = NEG, carry_b = NEG;
        for (int k = 0; k < chunks; ++k) {
            const int c0 = k * CHUNK + t * COLS;
            float a[COLS], vv[COLS], diag[COLS], shifted[COLS];
            bool vopen[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int c = c0 + j;
                float v = NEG, d = NEG, aa = NEG;
                bool vo = false;
                if (c <= R) {
                    const float v_open = bp[c] + go + ge;
                    const float v_ext = vp[c] + ge;
                    vo = v_open >= v_ext;
                    v = fmaxf(v_open, v_ext);
                    if (c > 0) d = bp[c - 1] + srow[c - 1];
                    aa = fmaxf(d, v);
                    if (c == 0) {
                        aa = border;
                        v = border;
                    }
                }
                a[j] = aa;
                vv[j] = v;
                diag[j] = d;
                vopen[j] = vo;
                shifted[j] = c <= R ? aa + go - ge * (float)c : NEG;
            }

            // run at c0: the max of NEG and shifted over the columns before
            float incl = shifted[0];
#pragma unroll
            for (int j = 1; j < COLS; ++j) incl = fmaxf(incl, shifted[j]);
            if (t == 0) incl = fmaxf(incl, carry_run);
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float o = __shfl_up_sync(FULL, incl, d);
                if (t >= d) incl = fmaxf(incl, o);
            }
            const float up = rotate_up(incl, t);
            float run = t == 0 ? carry_run : up;
            carry_run = up;

            float horiz[COLS], bnew[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int c = c0 + j;
                horiz[j] = c == 0 ? NEG : run + ge * (float)c;
                bnew[j] = fmaxf(a[j], horiz[j]);
                run = fmaxf(run, shifted[j]);
            }

            // horiz and unmasked best of column c-1
            const float hu = rotate_up(horiz[COLS - 1], t);
            const float bu = rotate_up(bnew[COLS - 1], t);
            float h_prev = t == 0 ? carry_h : hu;
            float b_prev = t == 0 ? carry_b : bu;
            carry_h = hu;
            carry_b = bu;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int c = c0 + j;
                if (c <= R) {
                    const bool hopen = b_prev + go >= h_prev;
                    uint32_t tr = diag[j] >= vv[j] ? 0u : 1u;
                    if (horiz[j] > a[j]) tr = 2u;
                    if (c == 0) tr = 1u;
                    orow[c] = (uint8_t)(tr | (vopen[j] ? 4u : 0u) | (hopen ? 8u : 0u));
                    const bool valid = c <= n;
                    bn[c] = valid ? bnew[j] : NEG;
                    vn[c] = valid ? vv[j] : NEG;
                }
                h_prev = horiz[j];
                b_prev = bnew[j];
            }
        }
        __syncwarp();
    }

    // -- rows past m: one contiguous block, 16-byte stores where aligned
    uint8_t* z = out + (size_t)(rows + 1) * W;
    const size_t len = (size_t)(Q - rows) * W;
    const size_t to_aligned = (16 - ((uintptr_t)z & 15)) & 15;
    const size_t head = to_aligned < len ? to_aligned : len;
    const size_t n16 = (len - head) / 16;
    for (size_t j = t; j < head; j += 32) z[j] = 0;
    uint4* z16 = reinterpret_cast<uint4*>(z + head);
    for (size_t j = t; j < n16; j += 32) z16[j] = make_uint4(0, 0, 0, 0);
    for (size_t j = head + 16 * n16 + t; j < len; j += 32) z[j] = 0;
}

template <int COLS>
int launch_cols(const Plan& p, const void* sub, const void* qlen, const void* rlen,
                float go, float ge, int B, int R, int Q, void* scratch, void* trace,
                void* stream)
{
    const int blocks = (B + p.warps - 1) / p.warps;
    realign_fill_sub_kernel<COLS><<<blocks, p.warps * 32, p.smem_bytes, (cudaStream_t)stream>>>(
        (const float*)sub, (const int32_t*)qlen, (const int32_t*)rlen, go, ge, B, R, Q,
        p.smem ? nullptr : (float*)scratch, p.stage, (uint8_t*)trace);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// realign_fill_scratch: the floats of global scratch per run that a launch
// at R needs, 0 when every warp's rows fit in shared memory; the caller
// then passes a [B, words] buffer as ``scratch`` (else null).
extern "C" int realign_fill_scratch(int R)
{
    return make_plan(R).smem ? 0 : (int)state_floats(R);
}

// Launches on ``stream`` and returns cudaGetLastError(); the caller
// allocates every buffer.
extern "C" int realign_fill_sub(
    const void* sub, const void* qlen, const void* rlen,
    float go, float ge, int B, int R, int Q,
    void* scratch, void* trace, void* stream)
{
    if (B <= 0) return (int)cudaGetLastError();
    const Plan p = make_plan(R);
    if (!p.smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    return p.cols == 2
        ? launch_cols<2>(p, sub, qlen, rlen, go, ge, B, R, Q, scratch, trace, stream)
        : launch_cols<1>(p, sub, qlen, rlen, go, ge, B, R, Q, scratch, trace, stream);
}
