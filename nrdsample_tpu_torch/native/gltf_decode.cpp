// Native glTF accessor decoding — the cgltf role in NRIFramework's scene
// loader (reference: utils::Scene load, NRDSample.cpp:2197-2241 consumes it).
// Python's per-element strided decode is ~1000x slower at Bistro-scale vertex
// counts; this does the strided walk + component-type widening in one pass.
//
// C ABI (ctypes, see native/__init__.py): all entry points return 0 on
// success, negative on bounds/argument errors. Component type codes are the
// glTF ones (5120 BYTE .. 5126 FLOAT). png_unfilter reconstructs the
// scanlines of the 8-bit PNG textures a glTF file embeds or names.

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

template <typename T>
inline void walk(const uint8_t* base, int64_t stride, int64_t count, int ncomp,
                 float* out) {
    for (int64_t i = 0; i < count; ++i) {
        const T* row = reinterpret_cast<const T*>(base + i * stride);
        for (int c = 0; c < ncomp; ++c) out[i * ncomp + c] = static_cast<float>(row[c]);
    }
}

template <typename T>
inline void walk_i64(const uint8_t* base, int64_t stride, int64_t count,
                     int ncomp, int64_t* out) {
    for (int64_t i = 0; i < count; ++i) {
        const T* row = reinterpret_cast<const T*>(base + i * stride);
        for (int c = 0; c < ncomp; ++c) out[i * ncomp + c] = static_cast<int64_t>(row[c]);
    }
}

inline int comp_size(int comp_type) {
    switch (comp_type) {
        case 5120: case 5121: return 1;
        case 5122: case 5123: return 2;
        case 5125: case 5126: return 4;
        default: return 0;
    }
}

}  // namespace

extern "C" {

// Decode `count` elements of `ncomp` components each, starting at byte
// `offset` with row stride `stride`, widening to float32.
int gltf_decode_f32(const uint8_t* buf, int64_t buf_len, int64_t offset,
                    int64_t stride, int64_t count, int ncomp, int comp_type,
                    float* out) {
    const int cs = comp_size(comp_type);
    if (cs == 0 || ncomp <= 0 || count < 0 || offset < 0 || stride < cs * ncomp)
        return -1;
    if (count > 0 && offset + (count - 1) * stride + cs * ncomp > buf_len)
        return -2;
    const uint8_t* base = buf + offset;
    switch (comp_type) {
        case 5120: walk<int8_t>(base, stride, count, ncomp, out); break;
        case 5121: walk<uint8_t>(base, stride, count, ncomp, out); break;
        case 5122: walk<int16_t>(base, stride, count, ncomp, out); break;
        case 5123: walk<uint16_t>(base, stride, count, ncomp, out); break;
        case 5125: walk<uint32_t>(base, stride, count, ncomp, out); break;
        case 5126: walk<float>(base, stride, count, ncomp, out); break;
    }
    return 0;
}

// Same, widening to int64 (index accessors: uint32 indices overflow f32).
int gltf_decode_i64(const uint8_t* buf, int64_t buf_len, int64_t offset,
                    int64_t stride, int64_t count, int ncomp, int comp_type,
                    int64_t* out) {
    const int cs = comp_size(comp_type);
    if (cs == 0 || comp_type == 5126 || ncomp <= 0 || count < 0 || offset < 0 ||
        stride < cs * ncomp)
        return -1;
    if (count > 0 && offset + (count - 1) * stride + cs * ncomp > buf_len)
        return -2;
    const uint8_t* base = buf + offset;
    switch (comp_type) {
        case 5120: walk_i64<int8_t>(base, stride, count, ncomp, out); break;
        case 5121: walk_i64<uint8_t>(base, stride, count, ncomp, out); break;
        case 5122: walk_i64<int16_t>(base, stride, count, ncomp, out); break;
        case 5123: walk_i64<uint16_t>(base, stride, count, ncomp, out); break;
        case 5125: walk_i64<uint32_t>(base, stride, count, ncomp, out); break;
    }
    return 0;
}

// Area-weighted vertex-normal accumulation for index triangles (the loader's
// fallback when NORMAL is absent): out[nv,3] += cross(e1, e2) scattered to
// the three corners, then caller normalizes. np.add.at is ~50x slower.
int gltf_accumulate_normals(const float* verts, int64_t nv, const int64_t* idx,
                            int64_t ntri, float* out) {
    if (nv < 0 || ntri < 0) return -1;
    std::memset(out, 0, sizeof(float) * 3 * static_cast<size_t>(nv));
    for (int64_t t = 0; t < ntri; ++t) {
        const int64_t a = idx[t * 3], b = idx[t * 3 + 1], c = idx[t * 3 + 2];
        if (a < 0 || b < 0 || c < 0 || a >= nv || b >= nv || c >= nv) return -2;
        const float* va = verts + a * 3;
        const float* vb = verts + b * 3;
        const float* vc = verts + c * 3;
        const float e1x = vb[0] - va[0], e1y = vb[1] - va[1], e1z = vb[2] - va[2];
        const float e2x = vc[0] - va[0], e2y = vc[1] - va[1], e2z = vc[2] - va[2];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        for (const int64_t v : {a, b, c}) {
            out[v * 3] += nx;
            out[v * 3 + 1] += ny;
            out[v * 3 + 2] += nz;
        }
    }
    return 0;
}

// PNG scanline unfiltering (the five filter types of the PNG spec, 9.2) of
// 8-bit images: `filtered` holds `height` rows of one filter-type byte and
// `row_bytes` filtered bytes each; `bpp` is the bytes per pixel. Writes the
// height * row_bytes reconstructed bytes to `out`. Returns -1 on a bad
// argument, -2 on an unknown filter type.
int png_unfilter(const uint8_t* filtered, int64_t height, int64_t row_bytes, int bpp,
                 uint8_t* out) {
    if (height < 0 || row_bytes < 0 || bpp <= 0) return -1;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* src = filtered + y * (row_bytes + 1);
        const int type = src[0];
        ++src;
        uint8_t* cur = out + y * row_bytes;
        const uint8_t* prev = y > 0 ? out + (y - 1) * row_bytes : nullptr;
        for (int64_t x = 0; x < row_bytes; ++x) {
            const int a = x >= bpp ? cur[x - bpp] : 0;
            const int b = prev ? prev[x] : 0;
            const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
            int pred;
            switch (type) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -2;
            }
            cur[x] = static_cast<uint8_t>(src[x] + pred);
        }
    }
    return 0;
}

}  // extern "C"
