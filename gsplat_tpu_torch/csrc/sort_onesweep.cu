// Kernel St': the instance sort's route for large frames, on Hopper
// (sm_90a). `ops/sort.py:sort_instances` takes it for more than
// ONESWEEP_MIN_KEYS (2^23) keys and St'' (`sort.cu`, a segmented sort) for
// fewer: St''s passes cost the same per key at any K, while St'''s scatter
// writes into buckets that outgrow L2 and more of its tiles go over its CAP
// (on an H100 80GB HBM3 at 700 W the two cross between 7.3M and 11.0M keys
// of the flagship's tiles, `scripts/sort_ablate.py`).
//
// St' replaces no Pallas kernel: the JAX package leaves the sort of its
// (tile, depth bits, gaussian id) instance keys to XLA (`lax.sort`,
// gsplat_tpu/ops/binning.py:758), and the port ran `torch.sort(keys,
// stable=True)` and gathered the gaussian ids by the permutation: CUB's
// onesweep over all 64 bits of the int64 key with an int64 index, eight
// passes of 32 bytes an instance.
//
// The key is K1''s `(tile << 32) | depth_bits`. The depth bits are those
// of a float32 above 0.2 (the projection marks only depth > 0.2 valid, and
// invalid rows emit no slot), or +inf: positive, so bit 31 of every key is
// 0, and the live bits are the depth's 31 and the tile's. St' sorts those
// alone, the key with bit 31 taken out (`live_bits`), `key_bits` of them:
// 31 + 13 at 1920x1080 (8,160 tiles), 31 + 15 at 3840x2160. The payload is
// the int32 gaussian id, which the pack reads in place of a permutation.
// Equal keys keep their slot order, which is gid order, so the result is
// `torch.sort(keys, stable=True)` and `gid[perm]` bit for bit.
//
// An LSD radix sort in the manner of Onesweep (Adinets and Merrill, 2022),
// DIGIT_BITS a pass, ceil(key_bits / DIGIT_BITS) passes:
//
//   sort_instances_hist  reads every key once (16 bytes a load) and counts
//                        the digits of every pass (per block in shared
//                        memory, then one global atomic per bin); the last
//                        block to finish writes each pass's exclusive digit
//                        offsets and zeroes the counters and its counter of
//                        finished blocks again.
//   sort_instances_pass  one launch a pass, one instantiation a digit
//                        position (its shifts known at compile time). A
//                        block takes the next tile of TILE keys by an
//                        atomic ticket (so the tiles before it are running
//                        or done), reads its keys (each warp load 32
//                        consecutive keys) and sends its gids to shared
//                        memory by asynchronous copies, ranks the keys
//                        stably within each warp (`__match_any_sync` on the
//                        digit, items in key order, a warp's own counters
//                        in shared memory), publishes its digit counts,
//                        lays the tile out in digit order in shared memory,
//                        finds each digit's count in the tiles before it by
//                        a decoupled look-back (Merrill and Garland),
//                        publishes its inclusive counts, and writes the tile
//                        out: the keys of one digit go to consecutive
//                        addresses.
//
// Look-back state: a persistent buffer per device, zeroed once when
// allocated. A word is (epoch << 34) | (state << 32) | count: one 64-bit
// store publishes the flag and the count together, and each pass of each
// launch has its own epoch, so a word of an earlier pass reads as not yet
// published and nothing is zeroed between passes or launches (no memset
// launch a sort). Launches on one stream share it, not launches on two
// streams at once.
//
// Bound on the card: bytes. The work is one read and one write of the key
// and the gid, 24 bytes an instance (87.8 MB on the 3,659,464 instances of
// the 1080p flagship frame); the design moves that once a pass and reads
// the keys once more for the histogram. What it does about it: it sorts
// only the key's live bits (6 passes of 8 bits for the 44 of a 1080p key,
// where the library sort makes 8 passes over 64) and carries the 4-byte gid
// in place of an 8-byte index; a pass reads each warp's keys as 32
// consecutive values and writes each digit's keys of a tile to consecutive
// addresses; the look-back state stays in L2. The digit width, the tile
// and the parts of a pass are measured by `scripts/sort_ablate.py` (on an
// H100 80GB HBM3 at 700 W): 11-bit digits (4 passes) ran 2.6-2.7x slower
// than 8-bit ones (2,048 bins a tile of 4,096 keys: runs of two keys a
// digit on the way out), tiles of 3,072 to 6,144 keys within 6%, and the
// gids read by the threads at layout time in place of the asynchronous
// copies 13-15% slower. A pass takes ~1.5x a copy of its bytes.

#include <stdint.h>

#include <array>
#include <utility>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int DIGIT_BITS = 8;
constexpr int RADIX = 1 << DIGIT_BITS;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // keys a thread in a pass
constexpr int WARP_ITEMS = 32 * ITEMS;
constexpr int TILE = THREADS * ITEMS;  // keys a block in a pass
constexpr int BINS = RADIX / THREADS;  // digits a thread scans and looks back over
constexpr int HIST_ITEMS = 16;         // consecutive keys a thread reads at a time
constexpr int MAX_KEY_BITS = 62;
constexpr int MAX_PASSES = (MAX_KEY_BITS + DIGIT_BITS - 1) / DIGIT_BITS;
constexpr long long MAX_EPOCH = 1ll << 30;
static_assert(RADIX % THREADS == 0 && BINS <= 32, "a thread's digits: a bit mask each");
static_assert(TILE < 65536, "a warp's digit offsets and ranks in 16 bits");
// a look-back word's state (bits 32-33): the tile's own count, or the
// count through the tile
constexpr unsigned long long LB_AGGREGATE = 1, LB_PREFIX = 2;

// shared memory of a pass: the tile's keys and gids in digit order, its
// gids in key order, each warp's digit counters, each digit's output base,
// the warp sums of a scan
constexpr size_t PASS_SMEM = TILE * 8 + 2 * TILE * 4 + WARPS * RADIX * 2 + RADIX * 4 + 64;
// of the histogram: the counters of every pass, the warp sums, a flag
constexpr size_t HIST_SMEM = MAX_PASSES * RADIX * 4 + 64;

// Digit PASS of the key's live bits (bit 31, a positive float's sign,
// taken out: live = (hi << 31) | (lo & 0x7fffffff)), its position known at
// compile time: one shift and mask from the low or the high word, or both
// where the digit spans the gap.
template <int PASS>
__device__ __forceinline__ unsigned digit_at(long long key)
{
    constexpr int S = PASS * DIGIT_BITS;
    const unsigned lo = (unsigned)key, hi = (unsigned)((unsigned long long)key >> 32);
    if constexpr (S + DIGIT_BITS <= 31)
        return (lo >> S) & (RADIX - 1);
    else if constexpr (S >= 31)
        return (hi >> (S - 31)) & (RADIX - 1);
    else
        return (((lo & 0x7fffffffu) >> S) | (hi << (31 - S))) & (RADIX - 1);
}

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p)
{
    return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_volatile(unsigned long long* p, unsigned long long v)
{
    *(volatile unsigned long long*)p = v;
}

// The block's exclusive scan of each thread's BINS values (thread t holds
// digits t * BINS ... t * BINS + BINS - 1). `s_warp` holds WARPS words,
// free again on return.
__device__ __forceinline__ void scan_bins(const unsigned (&v)[BINS], unsigned (&excl)[BINS],
                                              unsigned* s_warp)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
        excl[j] = sum;
        sum += v[j];
    }
    unsigned inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += u;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    unsigned before = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) before += w < warp ? s_warp[w] : 0u;
    const unsigned off = before + inc - sum;
#pragma unroll
    for (int j = 0; j < BINS; ++j) excl[j] += off;
    __syncthreads();
}

// A thread's `n` keys counted for pass PASS and the ones after it, up to
// `passes`, one shared atomic a key (counting a run of equal digits once
// was no faster: the atomics' conflicts are not what bounds this kernel)
template <int PASS>
__device__ __forceinline__ void count_digits(const long long (&kk)[HIST_ITEMS], int n,
                                             int passes, unsigned* s_h)
{
    if constexpr (PASS < MAX_PASSES) {
        if (PASS >= passes) return;
        unsigned* h = s_h + PASS * RADIX;
#pragma unroll
        for (int j = 0; j < HIST_ITEMS; ++j)
            if (j < n) atomicAdd(h + digit_at<PASS>(kk[j]), 1u);
        count_digits<PASS + 1>(kk, n, passes, s_h);
    }
}

__global__ void __launch_bounds__(THREADS) sort_instances_hist(
    const long long* __restrict__ keys,  // (K,), 16-byte aligned
    int k, int passes,
    unsigned* acc,        // (MAX_PASSES, RADIX) digit counts, 0 before and after a launch
    unsigned* bin_off,    // (MAX_PASSES, RADIX) each pass's exclusive digit offsets, out
    unsigned* done)       // () finished blocks, 0 before and after a launch
{
    extern __shared__ __align__(16) unsigned char sort_smem[];
    unsigned* s_h = reinterpret_cast<unsigned*>(sort_smem);  // (passes, RADIX)
    unsigned* s_warp = s_h + MAX_PASSES * RADIX;
    unsigned* s_last = s_warp + WARPS;

    const int t = threadIdx.x;
    for (int i = t; i < passes * RADIX; i += THREADS) s_h[i] = 0;
    __syncthreads();

    // a thread reads HIST_ITEMS consecutive keys at a time, 16 bytes a load
    constexpr int STEP = THREADS * HIST_ITEMS;
    for (long long b = (long long)blockIdx.x * STEP; b < k; b += (long long)gridDim.x * STEP) {
        const long long i0 = b + t * HIST_ITEMS;
        const int n = (int)max(0ll, min((long long)HIST_ITEMS, k - i0));
        long long kk[HIST_ITEMS];
        if (n == HIST_ITEMS) {
            const longlong2* v = reinterpret_cast<const longlong2*>(keys + i0);
#pragma unroll
            for (int j = 0; j < HIST_ITEMS / 2; ++j) {
                const longlong2 two = __ldg(v + j);
                kk[2 * j] = two.x;
                kk[2 * j + 1] = two.y;
            }
        } else {
#pragma unroll
            for (int j = 0; j < HIST_ITEMS; ++j) kk[j] = j < n ? __ldg(keys + i0 + j) : 0;
        }
        count_digits<0>(kk, n, passes, s_h);
    }
    __syncthreads();
    for (int i = t; i < passes * RADIX; i += THREADS) {
        const unsigned v = s_h[i];
        if (v) atomicAdd(acc + i, v);
    }
    __threadfence();
    __syncthreads();
    if (t == 0) *s_last = atomicAdd(done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!*s_last) return;

    // the last block: every count is in; the offsets out, the counters
    // zeroed for the next launch
    __threadfence();
    for (int p = 0; p < passes; ++p) {
        unsigned v[BINS], excl[BINS];
#pragma unroll
        for (int j = 0; j < BINS; ++j) v[j] = __ldcg(acc + p * RADIX + t * BINS + j);
        scan_bins(v, excl, s_warp);
#pragma unroll
        for (int j = 0; j < BINS; ++j) {
            bin_off[p * RADIX + t * BINS + j] = excl[j];
            acc[p * RADIX + t * BINS + j] = 0;
        }
    }
    if (t == 0) *done = 0;
}

template <int PASS>
__global__ void __launch_bounds__(THREADS) sort_instances_pass(
    const long long* __restrict__ keys_in,  // (K,)
    const int* __restrict__ gid_in,         // (K,)
    long long* __restrict__ keys_out,       // (K,)
    int* __restrict__ gid_out,              // (K,)
    int k,
    const unsigned* __restrict__ bin_off,   // (RADIX,) this pass's exclusive digit offsets
    unsigned long long* look,               // (tiles, RADIX) look-back words
    unsigned* ticket,                       // () 0 before and after a launch
    unsigned long long epoch)               // this pass's number, in [1, 2^30)
{
    extern __shared__ __align__(16) unsigned char sort_smem[];
    long long* s_keys = reinterpret_cast<long long*>(sort_smem);           // (TILE,)
    int* s_gid = reinterpret_cast<int*>(s_keys + TILE);                     // (TILE,)
    int* s_gin = s_gid + TILE;                                              // (TILE,)
    unsigned short* s_hist = reinterpret_cast<unsigned short*>(s_gin + TILE);  // (WARPS, RADIX)
    unsigned* s_base = reinterpret_cast<unsigned*>(s_hist + WARPS * RADIX);   // (RADIX,)
    unsigned* s_warp = s_base + RADIX;                                       // (WARPS,)
    int* s_tile = reinterpret_cast<int*>(s_warp + WARPS);

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t == 0) {
        const unsigned b = atomicAdd(ticket, 1u);
        *s_tile = (int)b;
        // the last ticket: every other block holds its own, the counter is free
        if (b == gridDim.x - 1) *ticket = 0u;
    }
    unsigned short* hist = s_hist + warp * RADIX;
    for (int d = lane; d < RADIX; d += 32) hist[d] = 0;
    __syncthreads();
    const int tile = *s_tile;

    // 1. the warp's WARP_ITEMS keys, item i of lane l the key base + 32 i + l
    // (each load 32 consecutive keys); past K all ones, whose digit is the
    // largest in every pass, so they rank after every key of the tile
    // (indices unsigned: K < 2^31, a tile may reach past it)
    const unsigned base = (unsigned)tile * TILE + warp * WARP_ITEMS + lane;
    long long key[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const unsigned idx = base + 32 * i;
        key[i] = idx < (unsigned)k ? keys_in[idx] : -1ll;
    }
    // the gids straight to shared memory in the same order (asynchronous
    // copies: no registers, and no wait until the tile is laid out)
    int* gin = s_gin + warp * WARP_ITEMS + lane;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const unsigned idx = base + 32 * i;
        if (idx < (unsigned)k) __pipeline_memcpy_async(gin + 32 * i, gid_in + idx, sizeof(int));
    }
    __pipeline_commit();

    // 2. ranks within the warp, items in order and lanes in order (key
    // order): the lanes of one digit take consecutive ranks after the
    // warp's count so far, which the lowest of them then advances
    // (a rank is under WARP_ITEMS: two to a register)
    const unsigned lt = (1u << lane) - 1u;
    unsigned rank2[(ITEMS + 1) / 2];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const unsigned d = digit_at<PASS>(key[i]);
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const unsigned before = hist[d];
        const unsigned r = before + __popc(peers & lt);
        rank2[i / 2] = i % 2 ? rank2[i / 2] | (r << 16) : r;
        __syncwarp();
        if ((peers & lt) == 0) hist[d] = (unsigned short)(before + __popc(peers));
        __syncwarp();
    }
    __syncthreads();

    // 3. each digit: the warps' exclusive offsets in place, the tile's count
    unsigned cnt[BINS];
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
        const int d = t * BINS + j;
        unsigned run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const unsigned c = s_hist[w * RADIX + d];
            s_hist[w * RADIX + d] = (unsigned short)run;
            run += c;
        }
        cnt[j] = run;
    }

    // 4. the tile's counts out at once (tile 0's are its inclusive counts)
    unsigned long long* mine = look + (size_t)tile * RADIX + t * BINS;
    const unsigned long long tag = epoch << 2;
#pragma unroll
    for (int j = 0; j < BINS; ++j)
        store_volatile(mine + j, ((tag | (tile == 0 ? LB_PREFIX : LB_AGGREGATE)) << 32) | cnt[j]);

    // 5. the tile in digit order in shared memory: a key's place is its
    // digit's offset in the tile, its warp's in the digit, its rank
    unsigned excl[BINS];
    scan_bins(cnt, excl, s_warp);
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
        const int d = t * BINS + j;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
            s_hist[w * RADIX + d] = (unsigned short)(s_hist[w * RADIX + d] + excl[j]);
    }
    __syncthreads();
    __pipeline_wait_prior(0);  // this thread's gid copies (past K: none)
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const unsigned rank = (rank2[i / 2] >> (16 * (i % 2))) & 0xffffu;
        const unsigned pos = hist[digit_at<PASS>(key[i])] + rank;
        s_keys[pos] = key[i];
        s_gid[pos] = gin[32 * i];
    }

    // 6. the look-back: each digit's count in the tiles before this one,
    // summing counts back to the nearest tile that has published its
    // inclusive count (tile 0's are); a thread's digits walk together
    unsigned prefix[BINS];
#pragma unroll
    for (int j = 0; j < BINS; ++j) prefix[j] = 0;
    if (tile > 0) {
        int at[BINS];
#pragma unroll
        for (int j = 0; j < BINS; ++j) at[j] = tile - 1;
        unsigned pending = BINS == 32 ? 0xffffffffu : (1u << BINS) - 1u;
        while (pending) {
            bool moved = false;
#pragma unroll
            for (int j = 0; j < BINS; ++j) {
                if (!((pending >> j) & 1u)) continue;
                const unsigned long long w = load_volatile(look + (size_t)at[j] * RADIX + t * BINS + j);
                if ((w >> 34) != epoch) continue;  // not yet published
                moved = true;
                prefix[j] += (unsigned)w;
                if (((w >> 32) & 3ull) == LB_PREFIX) pending &= ~(1u << j);
                else --at[j];
            }
            if (pending && !moved) __nanosleep(64);
        }
#pragma unroll
        for (int j = 0; j < BINS; ++j)
            store_volatile(mine + j, ((tag | LB_PREFIX) << 32) | (prefix[j] + cnt[j]));
    }
    // a digit's keys of this tile go to bin_off + prefix + (place - excl)
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
        const int d = t * BINS + j;
        s_base[d] = __ldg(bin_off + d) + prefix[j] - excl[j];
    }
    __syncthreads();

    // 7. out: consecutive places of a digit to consecutive addresses
    const int valid = min(TILE, k - tile * TILE);
    for (int j = t; j < valid; j += THREADS) {
        const long long kj = s_keys[j];
        const unsigned pos = s_base[digit_at<PASS>(kj)] + (unsigned)j;
        keys_out[pos] = kj;
        gid_out[pos] = s_gid[j];
    }
}

long long tiles_of(long long k) { return (k + TILE - 1) / TILE; }

// the state's words: the digit counts and the offsets (MAX_PASSES x RADIX
// unsigned each), the histogram's counter of finished blocks and the
// passes' ticket (one word), then the look-back (tiles x RADIX), which
// grows with K behind the fixed part
constexpr long long FIXED_WORDS = MAX_PASSES * RADIX + 1;
long long state_words(long long k) { return FIXED_WORDS + tiles_of(k) * RADIX; }

// the pass kernel of each digit position
using PassKernel = void (*)(const long long*, const int*, long long*, int*, int, const unsigned*,
                            unsigned long long*, unsigned*, unsigned long long);
template <int... P>
constexpr std::array<PassKernel, sizeof...(P)> pass_kernels(std::integer_sequence<int, P...>)
{
    return {sort_instances_pass<P>...};
}
constexpr std::array<PassKernel, MAX_PASSES> PASS_KERNELS =
    pass_kernels(std::make_integer_sequence<int, MAX_PASSES>{});

}  // namespace

// out[0] the state words a sort of `k` keys needs, out[1] its passes,
// out[2] DIGIT_BITS, out[3] TILE
extern "C" int gs_sort_layout(long long k, int key_bits, long long* out)
{
    if (k < 0 || key_bits < 1 || key_bits > MAX_KEY_BITS) return (int)cudaErrorInvalidValue;
    out[0] = state_words(k);
    out[1] = (key_bits + DIGIT_BITS - 1) / DIGIT_BITS;
    out[2] = DIGIT_BITS;
    out[3] = TILE;
    return 0;
}

// Sorts `k` (key, gid) pairs by the key's `key_bits` live bits, stably:
// keys_out and gid_out get the result; keys_tmp and gid_tmp are the other
// half of the ping-pong. Precondition: bit 31 of every key is 0 and its
// live bits are under 2^key_bits (K1''s keys of slots with depth > 0.2).
// `state` is the device's persistent state of `state_words` words, zeroed
// once when allocated; the passes take the epochs epoch ... epoch + passes
// - 1, each new on that state, in [1, 2^30).
extern "C" int gs_sort_instances(
    const void* keys, const void* gid, long long k, int key_bits, void* keys_tmp,
    void* gid_tmp, void* keys_out, void* gid_out, void* state, long long words,
    long long epoch, void* stream)
{
    const int passes = (key_bits + DIGIT_BITS - 1) / DIGIT_BITS;
    if (k <= 0 || k >= (1ll << 31) || key_bits < 1 || key_bits > MAX_KEY_BITS || epoch < 1
        || epoch + passes > MAX_EPOCH || words < state_words(k))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute((const void*)sort_instances_hist,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)HIST_SMEM);
    if (err != cudaSuccess) return (int)err;
    for (int p = 0; p < passes; ++p) {
        err = cudaFuncSetAttribute((const void*)PASS_KERNELS[p],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PASS_SMEM);
        if (err != cudaSuccess) return (int)err;
    }
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;

    const cudaStream_t s = (cudaStream_t)stream;
    const long long tiles = tiles_of(k);
    unsigned* acc = (unsigned*)state;
    unsigned* bin_off = acc + MAX_PASSES * RADIX;
    unsigned* done = bin_off + MAX_PASSES * RADIX;
    unsigned* ticket = done + 1;
    unsigned long long* look = (unsigned long long*)state + FIXED_WORDS;

    const long long hist_step = (long long)THREADS * HIST_ITEMS;
    const long long hist_need = (k + hist_step - 1) / hist_step;
    const long long hist_blocks = hist_need < 2ll * sms ? hist_need : 2ll * sms;
    sort_instances_hist<<<(unsigned)hist_blocks, THREADS, HIST_SMEM, s>>>(
        (const long long*)keys, (int)k, passes, acc, bin_off, done);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long* src_k = (const long long*)keys;
    const int* src_g = (const int*)gid;
    for (int p = 0; p < passes; ++p) {
        // the last pass writes the output, the ones before it alternate
        const bool to_out = (passes - 1 - p) % 2 == 0;
        long long* dst_k = (long long*)(to_out ? keys_out : keys_tmp);
        int* dst_g = (int*)(to_out ? gid_out : gid_tmp);
        const PassKernel pass = PASS_KERNELS[p];
        pass<<<(unsigned)tiles, THREADS, PASS_SMEM, s>>>(
            src_k, src_g, dst_k, dst_g, (int)k, bin_off + p * RADIX, look, ticket,
            (unsigned long long)(epoch + p));
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        src_k = dst_k;
        src_g = dst_g;
    }
    return 0;
}
