// siphash-2-4 content signatures and the byte-bounded LRU blob cache of the
// PyTorch port (counterpart of the first half of
// ccv_tpu/native/ccv_tpu_native.cpp; the reference's lib/ccv_cache.c LRU
// cache and lib/ccv_memory.c signatures). The image decoders of that file
// are not here: the port decodes PNG in Python and JPEG in image_decode.cpp.
//
// A plain C ABI bound with ctypes (ccv_tpu_torch/core/native.py), built
// with g++ by ccv_tpu_torch/_native_build.load_host_library.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <list>
#include <mutex>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// siphash-2-4 (public algorithm, Aumasson & Bernstein) for 64-bit content
// signatures — the same primitive the reference vendors for
// ccv_cache_generate_signature.
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int b) { return (x << b) | (x >> (64 - b)); }

uint64_t ccv_tpu_siphash24(const uint8_t* data, size_t len, const uint8_t key[16])
{
    uint64_t k0, k1;
    memcpy(&k0, key, 8);
    memcpy(&k1, key + 8, 8);
    uint64_t v0 = 0x736f6d6570736575ULL ^ k0;
    uint64_t v1 = 0x646f72616e646f6dULL ^ k1;
    uint64_t v2 = 0x6c7967656e657261ULL ^ k0;
    uint64_t v3 = 0x7465646279746573ULL ^ k1;
    const uint8_t* end = data + (len & ~7ULL);
    uint64_t b = (uint64_t)len << 56;

#define SIPROUND \
    v0 += v1; v1 = rotl64(v1, 13); v1 ^= v0; v0 = rotl64(v0, 32); \
    v2 += v3; v3 = rotl64(v3, 16); v3 ^= v2; \
    v0 += v3; v3 = rotl64(v3, 21); v3 ^= v0; \
    v2 += v1; v1 = rotl64(v1, 17); v1 ^= v2; v2 = rotl64(v2, 32);

    for (; data != end; data += 8) {
        uint64_t m;
        memcpy(&m, data, 8);
        v3 ^= m;
        SIPROUND; SIPROUND;
        v0 ^= m;
    }
    size_t left = len & 7;
    for (size_t i = 0; i < left; i++)
        b |= (uint64_t)data[i] << (8 * i);
    v3 ^= b;
    SIPROUND; SIPROUND;
    v0 ^= b;
    v2 ^= 0xff;
    SIPROUND; SIPROUND; SIPROUND; SIPROUND;
    return v0 ^ v1 ^ v2 ^ v3;
#undef SIPROUND
}

// ---------------------------------------------------------------------------
// byte-bounded LRU blob cache (ccv_cache_t twin: put/get/delete/drain)
// ---------------------------------------------------------------------------

struct CacheEntry {
    uint64_t sig;
    uint8_t* data;
    size_t size;
};

struct LruCache {
    size_t budget;
    size_t used = 0;
    std::list<CacheEntry> lru;  // front = most recent
    std::unordered_map<uint64_t, std::list<CacheEntry>::iterator> index;
    std::mutex mu;
};

void* ccv_tpu_cache_new(size_t budget)
{
    auto* c = new LruCache();
    c->budget = budget;
    return c;
}

static void cache_evict_locked(LruCache* c)
{
    while (c->used > c->budget && !c->lru.empty()) {
        CacheEntry& victim = c->lru.back();
        c->used -= victim.size;
        c->index.erase(victim.sig);
        free(victim.data);
        c->lru.pop_back();
    }
}

int ccv_tpu_cache_put(void* handle, uint64_t sig, const uint8_t* data, size_t size)
{
    auto* c = (LruCache*)handle;
    std::lock_guard<std::mutex> lock(c->mu);
    if (size > c->budget)
        return -1;
    auto it = c->index.find(sig);
    if (it != c->index.end()) {
        c->lru.splice(c->lru.begin(), c->lru, it->second);
        return 0;
    }
    uint8_t* copy = (uint8_t*)malloc(size);
    if (!copy)
        return -1;
    memcpy(copy, data, size);
    c->lru.push_front(CacheEntry{sig, copy, size});
    c->index[sig] = c->lru.begin();
    c->used += size;
    cache_evict_locked(c);
    return 0;
}

// returns size (0 = miss); caller passes a buffer of at least `cap` bytes
size_t ccv_tpu_cache_get(void* handle, uint64_t sig, uint8_t* out, size_t cap)
{
    auto* c = (LruCache*)handle;
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->index.find(sig);
    if (it == c->index.end())
        return 0;
    c->lru.splice(c->lru.begin(), c->lru, it->second);
    CacheEntry& e = *it->second;
    if (out && cap >= e.size)
        memcpy(out, e.data, e.size);
    return e.size;
}

int ccv_tpu_cache_delete(void* handle, uint64_t sig)
{
    auto* c = (LruCache*)handle;
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->index.find(sig);
    if (it == c->index.end())
        return -1;
    c->used -= it->second->size;
    free(it->second->data);
    c->lru.erase(it->second);
    c->index.erase(it);
    return 0;
}

void ccv_tpu_cache_drain(void* handle)
{
    auto* c = (LruCache*)handle;
    std::lock_guard<std::mutex> lock(c->mu);
    for (auto& e : c->lru)
        free(e.data);
    c->lru.clear();
    c->index.clear();
    c->used = 0;
}

size_t ccv_tpu_cache_size(void* handle)
{
    auto* c = (LruCache*)handle;
    std::lock_guard<std::mutex> lock(c->mu);
    return c->used;
}

void ccv_tpu_cache_free(void* handle)
{
    ccv_tpu_cache_drain(handle);
    delete (LruCache*)handle;
}

}  // extern "C"
