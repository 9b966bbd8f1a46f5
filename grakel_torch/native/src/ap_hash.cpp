// Batch ArashPartov string hash (same arithmetic as the reference's
// _c_functions/src/ArashPartov.cpp:8-20; public hash from
// partow.net/programming/hashfunctions).  One call hashes every string
// slice of a concatenated byte buffer.
extern "C" void ap_hash_batch(long n, const unsigned char* data,
                              const long* offsets, unsigned int* out) {
    for (long s = 0; s < n; ++s) {
        unsigned int h = 0xAAAAAAAAu;
        const long lo = offsets[s], hi = offsets[s + 1];
        for (long i = lo; i < hi; ++i) {
            const unsigned int b = data[i];
            if (((i - lo) & 1) == 0)
                h ^= ((h << 7) ^ (b * (h >> 3)));
            else
                h ^= ~((h << 11) + (b ^ (h >> 5)));
        }
        out[s] = h;
    }
}
