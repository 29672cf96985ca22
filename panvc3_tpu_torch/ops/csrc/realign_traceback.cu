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
// split route.  Each array is contiguous at any address (a view with an
// offset included).
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
// (i, j, state and count stay), so the walk stops there and the rest of
// its row holds the filler.
//
// Design.  The walk is serial within a run, so one thread walks each run,
// and what it waits for is memory: each step's address depends on the
// cell the step before read.  So the walk reads shared memory only, and
// the copy engine brings each run there ahead of it.  A persistent block
// (one per SM at the window) takes groups of S consecutive runs,
// blockIdx.x, + gridDim.x, ...; a group's trace, ref and query rows are
// one contiguous range each.  The block has `warps` walking warps
// (make_plan: four, or two for large tiles), each with a buffer of its
// own in a ring that warp 0 fills: lane r of warp 0 issues the bulk copy
// (cp.async.bulk) of the group's run r, lanes 0 and 1 those of its ref
// and query rows, each completing on the buffer's `full` mbarrier with its
// bytes announced first (mbarrier.expect_tx); then all 32 lanes arrive.
// Warp 0 loads a group's lengths a group ahead and refills a buffer as
// soon as its warp arrives on the buffer's `empty` mbarrier, so the other
// warps' groups are in flight while a warp walks (buffer c holds warp c's
// groups k = c, c + warps, ...; its use k / warps has phase parity
// (k / warps) & 1 on both barriers).  A range lands at its global address
// modulo 16, so any alignment of the inputs (2,401-byte runs at 48x48, an
// offset view) gives 16-byte-aligned bulk copies of its middle; its head
// and tail, under 16 bytes each, the walking lanes load into registers
// before they wait and store after, so that their latency passes during
// the copy.  Of run b's trace only what its walk can read is staged: flat
// indices 0 .. min(cells-1, m*(R+1)+n), since i and j never grow (nothing
// where that index is negative); the guard on the flat index stays, so a
// walk never reads the next run's bytes.  Lane r of a walking warp walks
// run r: the cell and the query and reference bytes a diagonal step
// compares are read together from shared memory, in one round trip.  The
// warp builds the group's ops rows in a shared buffer filled with the 127
// filler first, arrives on `empty`, stores the rows with 16-byte stores
// across the warp (the group's rows are one contiguous range of ops) and
// then the counts.  Tiles too large for two buffers of one run (cells
// above ~113 KB, e.g. 400x400) take the plan's global schedule: one thread
// per run walks from global memory, loading the cell and both compared
// bytes of a step together, and stores its ops and the filler itself.
//
// Bound on the H100 (SXM, 700 W).  On 16384 full 48x48 runs of random
// bases the walks take ~64 steps each (a diagonal step covers a row and a
// column at once).  Their ~20 integer operations a step (the cell's
// decode, the move, the op and the update) come to 1.26 us at 16.75 T
// op/s, above the 3.9 MB of the cells and bytes the walks read, the runs'
// lengths and every output byte (1.15 us at 3.35 TB/s), so operations set
// the bound (chip_smoke.py computes it from the inputs it times).  A
// design that stages tiles moves more: at the window every run is full,
// so its whole 2,401-byte trace is staged, 39.3 MB with the rows (11.7 us
// at 3.35 TB/s, less where the fill left it in L2), and the kernel cannot
// reach half the bound there; with random lengths only the prefixes move.
// What limits it is latency, not bytes: a buffer holds 22 runs at 48x48,
// so the 124 runs an SM takes at the window come in ~6 groups, about two
// per walking warp, and each group's copy and then its walk run in turn
// on its warp, a buffer refilling only once its warp is done; the block
// cannot hold more runs at once (227 KB is ~90 tiles of 48x48).  A walk's
// step costs ~75 ns (the 3,105 steps of chip_smoke.py's 3x5x3100 case take
// 0.23 ms): the compiled loop is ~70 instructions (cuobjdump -sass),
// issued by one walking warp per scheduler, around a dependent chain of a
// shared-memory load and the 64-bit index arithmetic (PERF.md has the
// times and the plans tried).

#include <cuda_runtime.h>
#include <stdint.h>

// the shared-memory schedule's block: barriers, ops rows, the ring
extern __shared__ __align__(128) uint8_t tb_smem[];

namespace {

constexpr int WARP = 32;
constexpr int MAX_RUNS = WARP;       // S: lane r of a walking warp walks run r of its group
constexpr int MAX_WALKERS = 4;       // walking warps per block, each on a buffer of its own
constexpr int MAX_THREADS = (1 + MAX_WALKERS) * WARP;  // warp 0 stages
constexpr int GLOBAL_THREADS = 64;   // the global schedule: runs per block
// Hopper: the most dynamic shared memory one block may opt in to
constexpr size_t SMEM_LIMIT = 232448;
// a wait this long means the ring's bookkeeping is wrong: trap, not hang
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;
constexpr int DIAG = 0, VERT = 1, HORIZ = 2;
constexpr int8_t OP_EQ = 7, OP_X = 8, OP_I = 1, OP_D = 2, FILLER = 127;

__host__ __device__ constexpr size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Plan {
    bool smem;          // the shared-memory schedule (else global)
    int runs;           // S: runs per group
    int warps;          // walking warps, and buffers in the ring: one each
    size_t slot;        // bytes per run's trace slot
    size_t ref_off;     // offsets within a buffer: the group's ref rows,
    size_t query_off;   //   then its query rows
    size_t stage_bytes; // one buffer
    size_t out_bytes;   // a walking warp's ops rows
    size_t smem_bytes;  // per block: barriers, ops rows, buffers
};

// Each range gets 15 bytes of slack, since it lands at its global address
// modulo 16.  Four walking warps, each with a buffer of the most runs (up
// to 32) for which the block fits in the 227 KB it may have; where not one
// run fits four times, two; where not even two buffers of one run fit
// (cells above ~113 KB), the global schedule.  Timed on the card
// (probe_traceback_plans.py, PERF.md): four walking warps of 22 runs at
// 48x48 are faster than two of 32 and eight of 11, and than six of 14 but
// on full 48x48 runs, where six are as fast or a few percent faster; more
// runs walking at once pay for a buffer that refills only when its warp
// is done.
Plan make_plan(int R, int Q)
{
    Plan p{};
    const size_t cells = (size_t)(Q + 1) * (size_t)(R + 1);
    p.slot = up16(cells + 15);
    for (int warps = MAX_WALKERS; warps >= 2; warps /= 2) {
        for (int S = MAX_RUNS; S >= 1; --S) {
            p.runs = S;
            p.warps = warps;
            p.ref_off = S * p.slot;
            p.query_off = p.ref_off + up16((size_t)S * R + 15);
            p.stage_bytes = p.query_off + up16((size_t)S * Q + 15);
            p.out_bytes = up16((size_t)S * (R + Q) + 15);
            p.smem_bytes = up16(2 * sizeof(uint64_t) * warps) + warps * (p.out_bytes + p.stage_bytes);
            if (p.smem_bytes <= SMEM_LIMIT) {
                p.smem = true;
                return p;
            }
        }
    }
    p.smem = false;
    p.runs = p.warps = 0;
    p.smem_bytes = 0;
    return p;
}

// -- mbarriers and the bulk copy (PTX, sm_90) -------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// release: this thread's shared-memory writes (and reads) before it are
// seen by the threads whose wait completes on this phase
__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile(
        "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
            smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return ok != 0;
}

__device__ __forceinline__ uint64_t now_ns()
{
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// wait for the phase of parity ``parity`` to complete (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    if (mbar_try_wait(bar, parity)) return;
    const uint64_t t0 = now_ns();
    while (!mbar_try_wait(bar, parity)) {
        if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
    }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"((uint64_t)__cvta_generic_to_global(src)), "r"(bytes),
        "r"(smem_addr(bar))
        : "memory");
}

// A range of ``len`` bytes at ``src`` lands in a 16-byte-aligned slot of
// shared memory at offset src % 16, so that shared and global addresses
// agree modulo 16.  Its 16-byte-aligned middle [head, tail) moves by one
// bulk copy, its head [0, head) and tail [tail, len), under 16 bytes each,
// by plain loads (without a middle: the first 16 bytes and the rest).
struct Range {
    size_t head, tail;
    __device__ Range(const uint8_t* src, size_t len)
    {
        const uintptr_t s0 = (uintptr_t)src;
        const uintptr_t a0 = up16(s0), a1 = (s0 + len) & ~(uintptr_t)15;
        if (a1 > a0) {
            head = a0 - s0;
            tail = a1 - s0;
        } else {
            head = tail = len < 16 ? len : 16;
        }
    }
};

// Warp 0's part of a range: the middle's bulk copy, completing on ``bar``
// (its bytes announced first).
__device__ void copy_middle(uint8_t* slot, const uint8_t* src, size_t len, uint64_t* bar)
{
    const Range r(src, len);
    if (r.tail > r.head) {
        uint8_t* dst = slot + ((uintptr_t)src & 15);
        mbar_expect_tx(bar, (uint32_t)(r.tail - r.head));
        bulk_copy(dst + r.head, src + r.head, (uint32_t)(r.tail - r.head), bar);
    }
}

// A walking lane's part: the head and tail bytes, loaded into registers
// before the buffer's wait, so that their latency passes during the bulk
// copies, and stored into the slot after it.
struct Edges {
    const uint8_t* src = nullptr;
    size_t head = 0, tail = 0, len = 0;
    uint8_t hb[16], tb[16];
    __device__ void load(const uint8_t* s, size_t n)
    {
        const Range r(s, n);
        src = s;
        head = r.head;
        tail = r.tail;
        len = n;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            hb[k] = k < head ? __ldg(s + k) : 0;
            tb[k] = tail + k < len ? __ldg(s + tail + k) : 0;
        }
    }
    __device__ void store(uint8_t* slot) const
    {
        uint8_t* dst = slot + ((uintptr_t)src & 15);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (k < head) dst[k] = hb[k];
            if (tail + k < len) dst[tail + k] = tb[k];
        }
    }
};

// The bytes of a run's trace that its walk can read: flat indices 0 ..
// min(cells-1, m*(R+1)+n), since i and j never grow (none where that
// index is negative).
__device__ __forceinline__ size_t staged_len(int m, int n, int W, long long cells)
{
    const long long first = (long long)m * W + n;
    const long long last = first < cells - 1 ? first : cells - 1;
    return last < 0 ? 0 : (size_t)last + 1;
}

// The warp stores the ``len`` bytes at ``src`` (shared memory, at the
// destination's address modulo 16) to ``dst``: 16 bytes a lane where
// aligned, the head and tail a byte a lane.
__device__ void store_range(int8_t* dst, const int8_t* src, size_t len, int lane)
{
    const uintptr_t d0 = (uintptr_t)dst;
    const uintptr_t a0 = up16(d0), a1 = (d0 + len) & ~(uintptr_t)15;
    size_t head = len, tail = len;
    if (a1 > a0) {
        head = a0 - d0;
        tail = a1 - d0;
        uint4* d16 = reinterpret_cast<uint4*>(dst + head);
        const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
        for (size_t w = lane; w < (a1 - a0) / 16; w += WARP) d16[w] = s16[w];
    }
    for (size_t k = lane; k < head; k += WARP) dst[k] = src[k];
    for (size_t k = tail + lane; k < len; k += WARP) dst[k] = src[k];
}

// -- the walk ---------------------------------------------------------------

// Where a walk reads its run's bytes and writes its ops: global memory
// (the global schedule) ...
struct GlobalRun {
    const uint8_t* tr;
    const uint8_t* qrow;
    const uint8_t* rrow;
    int8_t* orow;
    __device__ int cell(long long idx) const { return __ldg(tr + idx); }
    __device__ int query(int k) const { return __ldg(qrow + k); }
    __device__ int ref(int k) const { return __ldg(rrow + k); }
    __device__ void emit(int s, int8_t op) const { orow[s] = op; }
};

// ... or the block's shared memory, at 32-bit offsets into tb_smem
struct SharedRun {
    uint32_t tr, qrow, rrow, orow;
    __device__ int cell(long long idx) const { return tb_smem[tr + (uint32_t)idx]; }
    __device__ int query(int k) const { return tb_smem[qrow + k]; }
    __device__ int ref(int k) const { return tb_smem[rrow + k]; }
    __device__ void emit(int s, int8_t op) const { tb_smem[orow + s] = (uint8_t)op; }
};

// One run's walk from (m, n): emits its ops at steps 0 .. count and
// returns the count.
template <typename Run>
__device__ __forceinline__ int walk(const Run& run, int m, int n, int R, int Q, long long cells)
{
    const int W = R + 1;
    const int steps = R + Q;
    int i = m, j = n, state = 0, s = 0;
    for (; s < steps && !(i == 0 && j == 0); ++s) {
        const long long idx = (long long)i * W + j;
        // the cell and the two bytes a diagonal step compares: one round trip
        const int cell = idx >= 0 && idx < cells ? run.cell(idx) : 0;
        const int qc = i >= 1 && i <= Q ? run.query(i - 1) : 0;
        const int rc = j >= 1 && j <= R ? run.ref(j - 1) : 0;
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

        const int8_t op = is_diag ? (qc == rc ? OP_EQ : OP_X) : is_vert ? OP_I : OP_D;
        run.emit(s, op);

        const int ni = is_diag || is_vert ? i - 1 : i;
        const int nj = is_diag || is_horiz ? j - 1 : j;
        state = is_diag ? 0 : is_vert ? (vopen ? 0 : VERT) : (hopen ? 0 : HORIZ);
        i = ni;
        j = nj;
    }
    return s;
}

__global__ void __launch_bounds__(MAX_THREADS, 1) realign_traceback_staged(
    const uint8_t* __restrict__ trace,   // [B, Q+1, R+1]
    const uint8_t* __restrict__ ref,     // [B, R]
    const uint8_t* __restrict__ query,   // [B, Q]
    const int32_t* __restrict__ qlen,    // [B]  m
    const int32_t* __restrict__ rlen,    // [B]  n
    int B, int R, int Q, Plan p,
    int8_t* __restrict__ ops,            // [B, R+Q]
    int32_t* __restrict__ count)         // [B]
{
    uint8_t* sh = tb_smem;
    const int warp = threadIdx.x / WARP;
    const int lane = threadIdx.x % WARP;
    const int S = p.runs;
    const int groups = (B + S - 1) / S;
    const int W = R + 1;
    const int steps = R + Q;
    const long long cells = (long long)(Q + 1) * W;
    // warp c walks the block's groups k = c, c + warps, ... in buffer c;
    // its k-th group is the buffer's use k / warps, whose phase parity is
    // (k / warps) & 1 on both barriers
    uint64_t* full = reinterpret_cast<uint64_t*>(sh);
    uint64_t* empty = full + p.warps;
    uint8_t* outs = sh + up16(2 * sizeof(uint64_t) * p.warps);
    uint8_t* bufs = outs + p.warps * p.out_bytes;

    if (threadIdx.x == 0) {
        for (int k = 0; k < p.warps; ++k) {
            mbar_init(full + k, WARP);   // every lane of warp 0
            mbar_init(empty + k, WARP);  // every lane of the walking warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {
        // -- warp 0 stages the block's groups in order, each into its
        // buffer as soon as the buffer's warp is done with the group
        // before; a group's lengths are loaded a group ahead, so that their
        // latency passes while the group before is staged
        auto lengths = [&](int g, int& m, int& n) {
            m = n = 0;
            if (g < groups && lane < min(S, B - g * S)) {
                m = qlen[g * S + lane];
                n = rlen[g * S + lane];
            }
        };
        int m, n;
        lengths(blockIdx.x, m, n);
        int k = 0;
        for (int g = blockIdx.x; g < groups; g += gridDim.x, ++k) {
            const int slot = k % p.warps;
            const int use = k / p.warps;
            const int b0 = g * S;
            const int Sg = min(S, B - b0);
            int next_m, next_n;
            lengths(g + gridDim.x, next_m, next_n);
            if (use > 0) {
                mbar_wait(empty + slot, (use - 1) & 1);
                // the buffer's last use was read, and its edges written,
                // through the generic proxy; order those before this use's
                // bulk copies, which write through the async one
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            }
            uint8_t* buf = bufs + slot * p.stage_bytes;
            if (lane < Sg)
                copy_middle(buf + lane * p.slot, trace + (size_t)(b0 + lane) * cells,
                            staged_len(m, n, W, cells), full + slot);
            if (lane == 0) copy_middle(buf + p.ref_off, ref + (size_t)b0 * R, (size_t)Sg * R, full + slot);
            if (lane == 1)
                copy_middle(buf + p.query_off, query + (size_t)b0 * Q, (size_t)Sg * Q, full + slot);
            mbar_arrive(full + slot);
            m = next_m;
            n = next_n;
        }
        return;
    }

    // -- the walking warps
    const int c = warp - 1;
    uint8_t* out = outs + c * p.out_bytes;
    uint8_t* buf = bufs + c * p.stage_bytes;
    const uint32_t at = (uint32_t)(buf - sh);
    const uint4 filler = make_uint4(0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu);
    int use = 0;
    for (int g = blockIdx.x + c * gridDim.x; g < groups; g += p.warps * gridDim.x, ++use) {
        const int b0 = g * S;
        const int Sg = min(S, B - b0);
        int8_t* dst = ops + (size_t)b0 * steps;
        int8_t* rows = reinterpret_cast<int8_t*>(out) + ((uintptr_t)dst & 15);

        // the run's lengths and the bytes the bulk copies leave out, loaded
        // before the wait
        const int b = b0 + lane;
        int m = 0, n = 0;
        Edges te, re, qe;
        if (lane < Sg) {
            m = qlen[b];
            n = rlen[b];
            te.load(trace + (size_t)b * cells, staged_len(m, n, W, cells));
        }
        if (lane == 0) re.load(ref + (size_t)b0 * R, (size_t)Sg * R);
        if (lane == 1) qe.load(query + (size_t)b0 * Q, (size_t)Sg * Q);
        for (size_t w = lane; w < p.out_bytes / 16; w += WARP) reinterpret_cast<uint4*>(out)[w] = filler;
        mbar_wait(full + c, use & 1);
        te.store(buf + lane * p.slot);
        re.store(buf + p.ref_off);
        qe.store(buf + p.query_off);
        __syncwarp();  // the filler, and the rows' edges that lanes 0 and 1 stored
        int cnt = 0;
        if (lane < Sg) {
            SharedRun run;
            run.tr = at + lane * p.slot + (((uintptr_t)trace + (size_t)b * cells) & 15);
            run.rrow = at + p.ref_off + (((uintptr_t)ref + (size_t)b0 * R) & 15) + lane * R;
            run.qrow = at + p.query_off + (((uintptr_t)query + (size_t)b0 * Q) & 15) + lane * Q;
            run.orow = (uint32_t)((const uint8_t*)rows - sh) + lane * steps;
            cnt = walk(run, m, n, R, Q, cells);
        }
        mbar_arrive(empty + c);  // this lane is done with the buffer
        __syncwarp();            // every row is in ``out``
        store_range(dst, rows, (size_t)Sg * steps, lane);
        if (lane < Sg) count[b] = cnt;
        __syncwarp();            // ``out`` is read before the next filler
    }
}

__global__ void __launch_bounds__(GLOBAL_THREADS) realign_traceback_global(
    const uint8_t* __restrict__ trace, const uint8_t* __restrict__ ref,
    const uint8_t* __restrict__ query, const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ rlen, int B, int R, int Q,
    int8_t* __restrict__ ops, int32_t* __restrict__ count)
{
    const int b = blockIdx.x * GLOBAL_THREADS + threadIdx.x;
    if (b >= B) return;
    const long long cells = (long long)(Q + 1) * (R + 1);
    const int steps = R + Q;
    const GlobalRun run{trace + (size_t)b * cells, query + (size_t)b * Q, ref + (size_t)b * R,
                        ops + (size_t)b * steps};
    const int s = walk(run, qlen[b], rlen[b], R, Q, cells);
    for (int r = s; r < steps; ++r) run.orow[r] = FILLER;
    count[b] = s;
}

// The grid of the shared-memory schedule: one persistent block per group,
// at most as many as fit on the device at once.
int staged_grid(const Plan& p, int B, int* blocks)
{
    auto kern = realign_traceback_staged;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, (1 + p.warps) * WARP,
                                                      p.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int groups = (B + p.runs - 1) / p.runs;
    const int most = sms * (per_sm > 0 ? per_sm : 1);
    *blocks = groups < most ? groups : most;
    return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// realign_traceback_plan: the plan a launch at (B, R, Q) takes on the
// current device, as six ints in ``out``: the schedule (1 shared memory,
// 0 global), runs per group, walking warps per block (a buffer each),
// shared bytes per block, blocks, threads per block.  Launches nothing;
// returns a cudaError_t.
extern "C" int realign_traceback_plan(int B, int R, int Q, void* out)
{
    const Plan p = make_plan(R, Q);
    int* o = (int*)out;
    int blocks = 0;
    if (p.smem) {
        if (B > 0) {
            const int rc = staged_grid(p, B, &blocks);
            if (rc != 0) return rc;
        }
        const int v[6] = {1, p.runs, p.warps, (int)p.smem_bytes, blocks, (1 + p.warps) * WARP};
        for (int k = 0; k < 6; ++k) o[k] = v[k];
    } else {
        blocks = (B + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
        const int v[6] = {0, 0, 0, 0, blocks, GLOBAL_THREADS};
        for (int k = 0; k < 6; ++k) o[k] = v[k];
    }
    return 0;
}

// Launches on ``stream`` and returns cudaGetLastError(); the caller
// allocates every buffer.
extern "C" int realign_traceback(
    const void* trace, const void* ref, const void* query,
    const void* qlen, const void* rlen, int B, int R, int Q,
    void* ops, void* count, void* stream)
{
    if (B <= 0) return (int)cudaGetLastError();
    const Plan p = make_plan(R, Q);
    if (!p.smem) {
        const int blocks = (B + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
        realign_traceback_global<<<blocks, GLOBAL_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)trace, (const uint8_t*)ref, (const uint8_t*)query,
            (const int32_t*)qlen, (const int32_t*)rlen, B, R, Q, (int8_t*)ops, (int32_t*)count);
        return (int)cudaGetLastError();
    }
    int blocks = 0;
    const int rc = staged_grid(p, B, &blocks);
    if (rc != 0) return rc;
    realign_traceback_staged<<<blocks, (1 + p.warps) * WARP, p.smem_bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)trace, (const uint8_t*)ref, (const uint8_t*)query,
        (const int32_t*)qlen, (const int32_t*)rlen, B, R, Q, p, (int8_t*)ops, (int32_t*)count);
    return (int)cudaGetLastError();
}
