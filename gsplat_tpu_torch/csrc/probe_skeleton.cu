// Probes P1' and P2': the streaming skeletons of K2' and K3', on Hopper (sm_90a).
//
// Replace the Pallas kernels `_skel_fwd_kernel` (P1) and `_skel_bwd_kernel`
// (P2) of scripts/probe_ablate2.py (:32 and :52, launched by `run_skel_fwd`,
// :92, and `run_skel_bwd`, :112). Those are the TPU blend kernels with the
// chunk math dead: only the grid, the fetch loop and the emission are left.
// P2' is K3' (rasterize_bwd.cu) with the pair loop compiled out. P1' moves
// K2''s bytes (rasterize_fwd.cu: the ten table rows of every instance of
// every tile's range into the block's shared memory, the (T, 256, 8) output
// out) as Hopper streams them best: bulk copies into a ring of stages, in
// persistent blocks. So P1' is the floor that the staging of a K2' redesign
// can aim at, and K2' with its pair loop compiled out is K2''s own staging
// (`k2_skeleton` in scripts/skeleton_ablate.py). Timed on the same inputs as
// the full kernel, a skeleton splits the kernel's time into the streaming and
// the math.
//
// Both walk every tile's whole range: there is no early stop, as the
// probes' fori_loop has none (probe_ablate2.py:48,81). Write h_c =
// inst_t[0, 128 c] (the head of 128-aligned chunk c), base = s / 128 for tile
// t's range [s, e), and
//   acc(g) = sum_{c = base}^{g - 1} h_c * 1e-30
// in float32, in increasing c, each term added by one fused multiply-add
// (fmaf: one rounding). That is how XLA compiles the probes' `acc + h * 1e-30`
// on the CPU, where the JAX probes run in the tests (its LLVM target options
// always allow FP-op fusion). Then:
//   P1' (skel_fwd_kernel): out[t, :, :] = acc(ceil(e / 128)), broadcast over
//     (256, 8); 0 for an empty tile. This equals P1 bit for bit.
//   P2' (skel_bwd_kernel): dinst[r, j] = acc(j / 128) for every slot j of the
//     range and r < 10: the value P2 emits for j's chunk (:76-79). P2 hands a
//     chunk shared by two tiles from one grid step to the next (`_make_emit`,
//     rasterize_pallas.py:563-600), so on the columns of a tile's first chunk,
//     when s % 128 != 0, it adds the earlier tile's accumulator. Grid steps run
//     in order on a TPU and blocks here do not, so P2' writes 0 there. That
//     is the one deliberate difference.
//
// P1''s design. One block of 256 threads a tile staging with scalar loads
// and volatile stores took 0.160 ms on the flagship frame, 0.106 ms of it in
// its eight 4-byte output stores a thread at a 32-byte stride (PERF.md §6,
// `scripts/skeleton_ablate.py`). Here:
// - Persistent blocks: a grid of SMs x resident blocks (5 an SM), block b
//   walking the tiles b, b + G, b + 2G, ..., so one tile's output stores,
//   the next tile's range ends and its first copies overlap.
// - Warp 8 is the producer. One lane walks the block's items, a batch of up
//   to FWD_BATCH instances of a tile each (one item for an empty tile), into
//   a ring of FWD_STAGES stages in dynamic shared memory. For each it waits
//   until the stage is free (its `empty` mbarrier), arms the stage's `full`
//   mbarrier with the bytes it expects and copies each of the ten row
//   segments with one 1-D bulk copy (cp.async.bulk, the TMA), the segment
//   widened to whole 16-byte groups (its shift, 0-3 floats, is kept in the
//   stage); the 16-byte group of the chunk head before the range rides along
//   with a tile's first batch. The last partial 16-byte group of the table,
//   where no bulk copy may end, is read with plain loads: nothing outside
//   the table is read. The next tile's range ends are read while this tile's
//   batches are issued.
// - Warps 0-7 are the tile's 256 pixel threads. Each waits on `full`, reads
//   the chunk heads from the landed stage, frees the stage (one arrival a
//   warp on `empty`) and, after its tile's last batch, writes its pixel's
//   eight floats as two 16-byte stores.
// The ring's shape was measured on the flagship frame (PERF.md §6): 2
// stages of 512 instances (41 KB a block, 5 blocks an SM) ran 0.085 ms, 4
// of 256 (the first design, twice the copies) 0.095, 2 of 1024 (2 blocks an
// SM) 0.090, 3 of 1024 (1 block) 0.129: each block's one producer paces its
// reads, and five an SM keep enough of them in flight. At 5 blocks an SM a
// grid of one block a tile runs as fast (0.084); at 2, persistence saved
// 30%. The reads through bulk copies stay slower than the old scalar loads
// (2.26 against 2.64 TB/s, the output left out).
// What is kept of K2' and K3' for P2': one block of 256 threads per tile; the
// staging of [s, e) into shared memory in batches of 64 instances of all ten
// table rows, with K3''s barriers; K3''s prologue reads of the pixel's
// forward output and cotangent and its coalesced writes of ten rows per slot,
// each slot written once by its own tile's block, with no atomics. Its staging
// stores and prologue reads are volatile: nothing reads their values but the
// chunk heads, and the compiler would otherwise drop them as dead.
//
// Bound on the card: bytes. P1' moves K2''s bytes (ten rows per instance and
// two range ends per tile in, the (T, 256, 8) output out); P2' moves K3''s
// (the same rows and ranges plus the forward output and its cotangent in, ten
// rows per instance out). Their arithmetic is one fused multiply-add per
// chunk.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;

constexpr int CHUNK = 128;          // the TPU kernels' packet: 128 instances
constexpr float HEAD_SCALE = 1e-30f;
constexpr int BWD_BATCH = 64;       // K3''s batch
constexpr int N_GRAD = 10;

// ------------------------------------------------------------ P1' (skel_fwd)
constexpr int FWD_WARPS = PPT / 32;          // the pixel threads' warps
constexpr int FWD_THREADS = PPT + 32;        // and the producer warp
constexpr int FWD_BATCH = 512;              // instances an item stages
constexpr int FWD_STAGES = 2;
constexpr int SEG = FWD_BATCH + 4;           // floats of a staged row: a batch + shift, in 16-byte groups
constexpr int FIRST = 1, LAST = 2, HEAD = 4, DONE = 8;  // an item's flags
constexpr unsigned MBAR_PATIENCE = 1u << 24;

// One stage of the ring: the ten row segments of one batch, each starting at
// the 16-byte group that holds its first instance (`shift` floats into it),
// the group of the chunk head before the range, and the item's tile, first
// instance, count and flags.
struct __align__(16) FwdStage {
    float rows[N_ATTR][SEG];
    float4 head;
    int tile, b0, nb, flags;
    int shift[N_ATTR];
};

struct FwdShared {
    FwdStage stage[FWD_STAGES];
    unsigned long long full[FWD_STAGES];   // the stage's bytes have landed
    unsigned long long empty[FWD_STAGES];  // every pixel warp has read it
};
constexpr int FWD_SMEM = sizeof(FwdShared);  // dynamic shared memory a block

// mbarriers and bulk copies, by 32-bit shared-window addresses. A wait that
// has not returned after MBAR_PATIENCE tries traps, so a fault in the
// protocol fails the launch instead of hanging the card.
__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar)
{
    asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared.b64 st, [%0];\n\t}"
                 ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes)
{
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity)
{
    for (unsigned tries = 0;; ++tries) {
        unsigned done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (tries == MBAR_PATIENCE) __trap();
    }
}

// `bytes` (a multiple of 16) from 16-byte aligned `src` to `dst`, counted
// on `bar` when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The producer's one item: batch [b0, b0 + nb) of tile t (nb = 0 for an
// empty tile) into stage `st`, armed on `full`. Row r's instances are the
// floats [r k + b0, r k + b0 + nb) of the table; the copy covers the 16-byte
// groups from the one holding the first to the one holding the last, up to
// the table's last whole group `whole`; the floats past it are loaded here.
__device__ __forceinline__ void issue_item(
    FwdStage& st, unsigned long long* full, const float* __restrict__ inst_t, long long k,
    long long whole, int t, int b0, int nb, long long head_at, int flags)
{
    // each copy's bytes are expected before it is issued; the phase cannot
    // complete before the arrival below
    if (flags & HEAD) {
        mbar_expect_tx(full, 16u);
        bulk_copy(&st.head, inst_t + head_at, 16u, full);
    }
    for (int r = 0; r < (nb > 0 ? N_ATTR : 0); ++r) {
        const long long a = r * k + b0;
        const long long lo = a & ~3ll;
        const long long hi = min((a + nb + 3) & ~3ll, whole);
        if (hi > lo) {
            const unsigned bytes = (unsigned)(hi - lo) * 4u;
            mbar_expect_tx(full, bytes);
            bulk_copy(st.rows[r], inst_t + lo, bytes, full);
        }
        for (long long x = max(hi, a); x < a + nb; ++x) st.rows[r][x - lo] = inst_t[x];
        st.shift[r] = (int)(a - lo);
    }
    st.tile = t;
    st.b0 = b0;
    st.nb = nb;
    st.flags = flags;
    mbar_arrive(full);  // releases the stores above
}

__global__ void __launch_bounds__(FWD_THREADS) skel_fwd_kernel(
    const float* __restrict__ inst_t,  // (rows, K), 16-byte aligned
    long long k,
    long long table_floats,            // rows * K
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int num_tiles,
    float* __restrict__ out)           // (T, 256, 8)
{
    extern __shared__ __align__(16) unsigned char fwd_smem[];
    FwdShared& sm = *reinterpret_cast<FwdShared*>(fwd_smem);
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    if (tid == 0) {
        for (int i = 0; i < FWD_STAGES; ++i) {
            mbar_init(&sm.full[i], 1);
            mbar_init(&sm.empty[i], FWD_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= PPT) {  // the producer warp: one lane issues
        if (lane != 0) return;
        const long long whole = table_floats & ~3ll;
        int item = 0;
        int t = blockIdx.x;
        int s = t < num_tiles ? tile_start[t] : 0;
        int e = t < num_tiles ? tile_end[t] : 0;
        for (; t < num_tiles; t += gridDim.x) {
            const int tn = t + gridDim.x;
            const int sn = tn < num_tiles ? tile_start[tn] : 0;
            const int en = tn < num_tiles ? tile_end[tn] : 0;
            const int base = s / CHUNK;
            const int n = e > s ? e - s : 0;
            const int batches = n > 0 ? (n + FWD_BATCH - 1) / FWD_BATCH : 1;
            for (int j = 0; j < batches; ++j, ++item) {
                const int i = item % FWD_STAGES;
                if (item >= FWD_STAGES) {
                    mbar_wait(&sm.empty[i], ((item / FWD_STAGES) - 1) & 1);
                    // the pixel threads' reads before the copies' writes
                    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                }
                const int b0 = s + j * FWD_BATCH;
                int flags = (j == 0 ? FIRST : 0) | (j == batches - 1 ? LAST : 0);
                if (j == 0 && n > 0 && base * CHUNK < s) flags |= HEAD;
                issue_item(sm.stage[i], &sm.full[i], inst_t, k, whole, t, b0,
                           n > 0 ? min(FWD_BATCH, e - b0) : 0, (long long)base * CHUNK, flags);
            }
            s = sn;
            e = en;
        }
        const int i = item % FWD_STAGES;
        if (item >= FWD_STAGES) mbar_wait(&sm.empty[i], ((item / FWD_STAGES) - 1) & 1);
        sm.stage[i].flags = DONE;
        mbar_arrive(&sm.full[i]);
        return;
    }

    float acc = 0.0f;
    for (int item = 0;; ++item) {
        const int i = item % FWD_STAGES;
        mbar_wait(&sm.full[i], (item / FWD_STAGES) & 1);
        const FwdStage& st = sm.stage[i];
        const int flags = st.flags;
        if (flags & DONE) break;
        const int t = st.tile, b0 = st.b0, nb = st.nb;
        const float* row0 = st.rows[0] + st.shift[0];  // row 0 of instance b0 + j at row0[j]
        if (flags & FIRST) acc = (flags & HEAD) ? fmaf(st.head.x, HEAD_SCALE, 0.0f) : 0.0f;
        // the heads of the chunks that start inside this batch, in order
        for (int h = (b0 + CHUNK - 1) / CHUNK * CHUNK; h < b0 + nb; h += CHUNK)
            acc = fmaf(row0[h - b0], HEAD_SCALE, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[i]);
        if (flags & LAST) {
            float4* o = reinterpret_cast<float4*>(out + ((long long)t * PPT + tid) * 8);
            const float4 v = make_float4(acc, acc, acc, acc);
            o[0] = v;
            o[1] = v;
        }
    }
}

__global__ void __launch_bounds__(PPT) skel_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent
    float* __restrict__ dinst)         // (10, K)
{
    __shared__ float batch[N_ATTR][BWD_BATCH];
    volatile float(*staged)[BWD_BATCH] = batch;

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int s = tile_start[t];
    const int e = tile_end[t];

    // K3''s prologue reads: channels 0-4 of the pixel's forward output and
    // cotangent
    const volatile float* f = fwd + ((long long)t * PPT + tid) * 8;
    const volatile float* d = dout + ((long long)t * PPT + tid) * 8;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
        (void)f[c];
        (void)d[c];
    }

    // chunk g_cur holds the slots walked so far; acc = acc(g_cur), prev =
    // acc(g_cur - 1) for the slots of a batch that precede g_cur's start;
    // head = h_{g_cur} once read
    const int base = s / CHUNK;
    int g_cur = base;
    float acc = 0.0f, prev = 0.0f;
    float head = (e > s && base * CHUNK < s) ? inst_t[(long long)base * CHUNK] : 0.0f;

    for (int b0 = s; b0 < e; b0 += BWD_BATCH) {
        __syncthreads();  // the previous batch's readers are done
        const int nb = min(BWD_BATCH, e - b0);
        if (tid < nb) {
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) staged[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        // at most one chunk starts inside a batch of 64
        const int c = (b0 + CHUNK - 1) / CHUNK;
        if (c * CHUNK < b0 + nb) {
            if (c > g_cur) {
                prev = acc;
                acc = fmaf(head, HEAD_SCALE, acc);
                g_cur = c;
            }
            head = staged[0][c * CHUNK - b0];
        }
        __syncthreads();  // K3''s barrier before the row writes
        for (int idx = tid; idx < N_GRAD * nb; idx += PPT) {
            const int r = idx / nb;
            const int j = idx - r * nb;
            dinst[r * k + b0 + j] = (b0 + j) / CHUNK == g_cur ? acc : prev;
        }
    }
}

// the persistent grid's cap, SMs x resident blocks, asked once per device
constexpr int MAX_DEVICES = 64;

int fwd_grid_cap(int* cap)
{
    static int caps[MAX_DEVICES];
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES && caps[dev] > 0) {
        *cap = caps[dev];
        return 0;
    }
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute((const void*)skel_fwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)skel_fwd_kernel,
                                                            FWD_THREADS, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    *cap = (sms > 1 ? sms : 1) * (per_sm > 1 ? per_sm : 1);
    if (dev < MAX_DEVICES) caps[dev] = *cap;
    return 0;
}

}  // namespace

extern "C" int gs_skel_fwd(
    const void* inst_t, long long k, int rows, const void* tile_start, const void* tile_end,
    int num_tiles, void* out, void* stream)
{
    if (num_tiles <= 0) return 0;
    int cap = 0;
    const int err = fwd_grid_cap(&cap);
    if (err != 0) return err;
    skel_fwd_kernel<<<(num_tiles < cap ? num_tiles : cap), FWD_THREADS, FWD_SMEM,
                      (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (long long)rows * k, (const int*)tile_start, (const int*)tile_end,
        num_tiles, (float*)out);
    return (int)cudaGetLastError();
}

// P1''s build and launch facts: registers a thread, shared bytes a block,
// resident blocks an SM, the persistent grid's cap
extern "C" int gs_skel_fwd_info(int* out)
{
    int cap = 0;
    const int cap_err = fwd_grid_cap(&cap);  // sets the shared-memory attribute
    if (cap_err != 0) return cap_err;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)skel_fwd_kernel);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)skel_fwd_kernel,
                                                        FWD_THREADS, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = FWD_SMEM + (int)attr.sharedSizeBytes;
    out[2] = per_sm;
    out[3] = cap;
    return 0;
}

extern "C" int gs_skel_bwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, const void* fwd, const void* dout, void* dinst, void* stream)
{
    skel_bwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        (const float*)fwd, (const float*)dout, (float*)dinst);
    return (int)cudaGetLastError();
}
