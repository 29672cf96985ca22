// Affine-gap DP fill for Hopper from explicit substitution scores: the
// split route's fill (the traceback runs after it, in PyTorch).
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
// Design.  One thread per run, walking every column 0..R of every row
// 1..min(m, Q) (its whole trace is the output) and zero-filling the rows
// past m.  Within a row the horizontal gap uses the sequential recurrence
// h[c] = max(a[c-1] + go + ge, h[c-1] + ge), equal to the plain fill's
// prefix max: every real score is an integer exact in f32, and -1e30
// absorbs any small addend, so a NEG term never wins a max against a real
// one (and column 0's border keeps every h real).  Compile with
// -fmad=false.  The previous DP row (best, vert: f32) lives in global
// scratch laid out [column][run], coalesced across a warp.
//
// What bounds it on the H100.  The stores: each thread writes its own
// [Q+1][R+1] byte block, so a warp's 32 stores of one column land in 32
// different cache lines (uncoalesced), and the substitution tile is read
// the same way (each thread along its own contiguous row; L1 keeps the
// lines between columns).  Behind that, the same latency chain as the
// fused kernel: ~10 dependent f32 operations per cell with few warps per
// SM at the window shape.  A later design can stage a warp's rows in
// shared memory and store them coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS) realign_fill_sub_kernel(
    const float* __restrict__ sub,       // [B, Q, R]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    float go, float ge, int B, int R, int Q,
    float* __restrict__ best,            // [R+1, B] scratch
    float* __restrict__ vert,            // [R+1, B] scratch
    uint8_t* __restrict__ trace)         // [B, Q+1, R+1]
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int m = qlen[b];
    const int n = rlen[b];
    const int W = R + 1;
    const size_t sb = (size_t)B;
    uint8_t* out = trace + (size_t)b * (Q + 1) * W;

    // -- row 0
    for (int c = 0; c <= R; ++c) {
        const float b0 = c == 0 ? 0.0f : go + ge * (float)c;
        best[(size_t)c * sb + b] = c <= n ? b0 : NEG;
        vert[(size_t)c * sb + b] = NEG;
        out[c] = c == 0 ? 0 : (uint8_t)(2u | (c == 1 ? 8u : 0u));
    }

    // column 0's hopen compares two NEG sentinels (b_prev = h_prev = NEG)
    const uint8_t hopen0 = (NEG + go >= NEG) ? 8u : 0u;
    const int rows = min(max(m, 0), Q);

    // -- rows 1..min(m, Q)
    for (int i = 1; i <= rows; ++i) {
        const float* srow = sub + ((size_t)b * Q + i - 1) * R;
        uint8_t* orow = out + (size_t)i * W;
        const float border = go + ge * (float)i;
        const float bp0 = best[b];
        const float vp0 = vert[b];
        const bool vopen0 = (bp0 + go + ge) >= (vp0 + ge);
        // column 0: a = vert = border, horiz = NEG, the move forced vert
        orow[0] = (uint8_t)(1u | (vopen0 ? 4u : 0u) | hopen0);
        best[b] = 0 <= n ? border : NEG;
        vert[b] = 0 <= n ? border : NEG;

        float diag_src = bp0;  // best of the previous row, column c-1
        float a_prev = border; // a of this row, column c-1
        float h_prev = NEG;    // horiz of this row, column c-1
        float b_prev = border; // unmasked best of this row, column c-1
        for (int c = 1; c <= R; ++c) {
            const size_t at = (size_t)c * sb + b;
            const float bpc = best[at];
            const float vpc = vert[at];
            const float v_open = bpc + go + ge;
            const float v_ext = vpc + ge;
            const bool vopen = v_open >= v_ext;
            const float vv = fmaxf(v_open, v_ext);
            const float diag = diag_src + srow[c - 1];
            const float a = fmaxf(diag, vv);
            const float h = fmaxf(a_prev + go + ge, h_prev + ge);
            const bool hopen = b_prev + go >= h_prev;
            uint32_t tr = diag >= vv ? 0u : 1u;
            if (h > a) tr = 2u;
            const float bc = fmaxf(a, h);
            orow[c] = (uint8_t)(tr | (vopen ? 4u : 0u) | (hopen ? 8u : 0u));
            const bool valid = c <= n;
            best[at] = valid ? bc : NEG;
            vert[at] = valid ? vv : NEG;
            diag_src = bpc;
            a_prev = a;
            h_prev = h;
            b_prev = bc;
        }
    }

    // -- rows past m
    for (int i = rows + 1; i <= Q; ++i) {
        uint8_t* orow = out + (size_t)i * W;
        for (int c = 0; c <= R; ++c) orow[c] = 0;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns cudaGetLastError(); the caller allocates every buffer.
extern "C" int realign_fill_sub(
    const void* sub, const void* qlen, const void* rlen,
    float go, float ge, int B, int R, int Q,
    void* best, void* vert, void* trace, void* stream)
{
    if (B > 0) {
        const int blocks = (B + THREADS - 1) / THREADS;
        realign_fill_sub_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)sub, (const int32_t*)qlen, (const int32_t*)rlen,
            go, ge, B, R, Q, (float*)best, (float*)vert, (uint8_t*)trace);
    }
    return (int)cudaGetLastError();
}
