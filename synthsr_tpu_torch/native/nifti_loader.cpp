// Native NIfTI-1 volume loader: gzip inflate + header parse + dtype cast.
//
// The host input pipeline is the training bottleneck the reference inherits
// from its synchronous python generator (SynthSR/model_inputs.py:77-139).
// This loader reads .nii/.nii.gz straight into a caller-provided buffer with
// a single cast pass, releases the GIL (called via ctypes), and so scales
// across prefetch threads.  Build: g++ -O3 -shared -fPIC -lz.
//
// ABI (all little-endian hosts):
//   nifti_read_header(path, hdr348) -> 0 | error
//   nifti_read(path, out, capacity_bytes, out_dtype) -> n_voxels | -error
//     out_dtype: 0 = float32, 1 = int32
// Errors: 1 open, 2 header, 3 unsupported dtype, 4 capacity, 5 truncated.

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kHdrSize = 348;

struct Header {
    int16_t dim[8];
    int16_t datatype;
    float vox_offset;
    float scl_slope;
    float scl_inter;
};

bool parse_header(const unsigned char* raw, Header* h) {
    int32_t sizeof_hdr;
    std::memcpy(&sizeof_hdr, raw, 4);
    if (sizeof_hdr != kHdrSize) return false;  // big-endian handled in python
    std::memcpy(h->dim, raw + 40, 16);
    std::memcpy(&h->datatype, raw + 70, 2);
    std::memcpy(&h->vox_offset, raw + 108, 4);
    std::memcpy(&h->scl_slope, raw + 112, 4);
    std::memcpy(&h->scl_inter, raw + 116, 4);
    return true;
}

int64_t n_voxels(const Header& h) {
    int nd = h.dim[0];
    int64_t n = 1;
    for (int i = 1; i <= nd && i < 8; ++i) n *= h.dim[i] > 0 ? h.dim[i] : 1;
    return n;
}

template <typename SRC, typename DST>
void cast_loop(const unsigned char* src, DST* dst, int64_t n) {
    const SRC* s = reinterpret_cast<const SRC*>(src);
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<DST>(s[i]);
}

// float -> int must ROUND (reference load_volume does np.round before
// astype(int), utils.py:104-106), not truncate
template <>
void cast_loop<float, int32_t>(const unsigned char* src, int32_t* dst, int64_t n) {
    const float* s = reinterpret_cast<const float*>(src);
    for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<int32_t>(s[i] >= 0 ? s[i] + 0.5f : s[i] - 0.5f);
}

template <>
void cast_loop<double, int32_t>(const unsigned char* src, int32_t* dst, int64_t n) {
    const double* s = reinterpret_cast<const double*>(src);
    for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<int32_t>(s[i] >= 0 ? s[i] + 0.5 : s[i] - 0.5);
}

template <typename DST>
int cast_any(int datatype, const unsigned char* src, DST* dst, int64_t n) {
    switch (datatype) {
        case 2:   cast_loop<uint8_t>(src, dst, n); return 0;
        case 4:   cast_loop<int16_t>(src, dst, n); return 0;
        case 8:   cast_loop<int32_t>(src, dst, n); return 0;
        case 16:  cast_loop<float>(src, dst, n); return 0;
        case 64:  cast_loop<double>(src, dst, n); return 0;
        case 256: cast_loop<int8_t>(src, dst, n); return 0;
        case 512: cast_loop<uint16_t>(src, dst, n); return 0;
        case 768: cast_loop<uint32_t>(src, dst, n); return 0;
        default:  return 3;
    }
}

int item_size(int datatype) {
    switch (datatype) {
        case 2: case 256: return 1;
        case 4: case 512: return 2;
        case 8: case 16: case 768: return 4;
        case 64: return 8;
        default: return 0;
    }
}

// read exactly n bytes via zlib (handles both gzip and plain files)
bool gz_read_exact(gzFile f, void* buf, int64_t n) {
    unsigned char* p = static_cast<unsigned char*>(buf);
    while (n > 0) {
        unsigned chunk = n > (1 << 30) ? (1u << 30) : static_cast<unsigned>(n);
        int got = gzread(f, p, chunk);
        if (got <= 0) return false;
        p += got;
        n -= got;
    }
    return true;
}

}  // namespace

extern "C" {

int nifti_read_header(const char* path, unsigned char* hdr348) {
    gzFile f = gzopen(path, "rb");
    if (!f) return 1;
    bool ok = gz_read_exact(f, hdr348, kHdrSize);
    gzclose(f);
    return ok ? 0 : 2;
}

// Returns the number of voxels written, or -error.
int64_t nifti_read(const char* path, void* out, int64_t capacity_bytes,
                   int out_dtype) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    unsigned char hdr[kHdrSize];
    if (!gz_read_exact(f, hdr, kHdrSize)) { gzclose(f); return -2; }
    Header h;
    if (!parse_header(hdr, &h)) { gzclose(f); return -2; }
    int isz = item_size(h.datatype);
    if (isz == 0) { gzclose(f); return -3; }

    int64_t n = n_voxels(h);
    int64_t out_item = 4;  // float32 / int32
    if (capacity_bytes < n * out_item) { gzclose(f); return -4; }

    // skip to vox_offset
    int64_t skip = static_cast<int64_t>(h.vox_offset) - kHdrSize;
    std::vector<unsigned char> tmp;
    if (skip > 0) {
        tmp.resize(skip);
        if (!gz_read_exact(f, tmp.data(), skip)) { gzclose(f); return -5; }
    }

    tmp.resize(n * isz);
    if (!gz_read_exact(f, tmp.data(), n * isz)) { gzclose(f); return -5; }
    gzclose(f);

    int rc;
    if (out_dtype == 0) {
        rc = cast_any<float>(h.datatype, tmp.data(), static_cast<float*>(out), n);
        // scl_slope/inter semantics identical to the python reader
        // (io/nifti.py:153-159): non-finite or zero slope acts as 1.0,
        // non-finite inter as 0.0; scale when effective (slope, inter)
        // differs from (1, 0).
        float slope = h.scl_slope, inter = h.scl_inter;
        bool apply = (std::isfinite(slope) && slope != 0.0f && slope != 1.0f)
                  || (std::isfinite(inter) && inter != 0.0f);
        if (rc == 0 && apply) {
            if (!std::isfinite(slope) || slope == 0.0f) slope = 1.0f;
            if (!std::isfinite(inter)) inter = 0.0f;
            float* o = static_cast<float*>(out);
            for (int64_t i = 0; i < n; ++i) o[i] = o[i] * slope + inter;
        }
    } else {
        rc = cast_any<int32_t>(h.datatype, tmp.data(), static_cast<int32_t*>(out), n);
    }
    if (rc != 0) return -rc;
    return n;
}

}  // extern "C"
