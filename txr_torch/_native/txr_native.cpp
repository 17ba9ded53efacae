// txr_torch native host runtime: fast point-cloud I/O and packing.
//
// The port's copy of txr/_native/txr_native.cpp (same code, same C ABI), so
// that txr_torch builds its own library and never loads txr's. It replaces
// the reference's Open3D C++ I/O layer: binary PLY emit and PointCloud2-style
// XYZRGB packing as tight single-pass C loops over interleaved records,
// masked point compaction, and the JPEG / 16-bit PNG host codecs. Exposed
// through a plain C ABI and loaded via ctypes.
//
// Build (txr_torch/_native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o libtxr_torch_native.so txr_native.cpp
//       [-DTXR_HAVE_JPEG -ljpeg] [-DTXR_HAVE_PNG -lpng]

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

#ifdef TXR_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

#ifdef TXR_HAVE_PNG
#include <csetjmp>
#include <png.h>
#endif

extern "C" {

#ifdef TXR_HAVE_JPEG
// ---- JPEG decode (SURVEY §2.8 item 15: host decode feeding reusable
// staging buffers). libjpeg with the default islow IDCT — bit-compatible
// with cv2's bundled libjpeg-turbo for baseline JPEGs.

struct txr_jpeg_err {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void txr_jpeg_fail(j_common_ptr cinfo) {
    txr_jpeg_err* e = (txr_jpeg_err*)cinfo->err;
    longjmp(e->jb, 1);
}

// Probe dimensions: returns 0 and fills w/h/channels, or -1 on parse error.
int txr_jpeg_dims(const uint8_t* data, int64_t len, int* w, int* h, int* c) {
    jpeg_decompress_struct cinfo;
    txr_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = txr_jpeg_fail;
    if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    *c = 3;  // decode always emits BGR
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode into caller-provided BGR uint8 buffer of h*w*3 bytes (the caller
// keeps a reusable pool so hot loops stage into stable addresses).
// Returns 0 on success, -1 on decode error.
int txr_decode_jpeg(const uint8_t* data, int64_t len, uint8_t* out,
                    int w, int h) {
    jpeg_decompress_struct cinfo;
    txr_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = txr_jpeg_fail;
    if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
#ifdef JCS_EXTENSIONS
    cinfo.out_color_space = JCS_EXT_BGR;  // turbo fast path when present
#else
    cinfo.out_color_space = JCS_RGB;
#endif
    jpeg_start_decompress(&cinfo);
    if ((int)cinfo.output_width != w || (int)cinfo.output_height != h ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + (int64_t)cinfo.output_scanline * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
#ifndef JCS_EXTENSIONS
    // swap RGB -> BGR in place
    for (int64_t i = 0; i < (int64_t)w * h; ++i) {
        uint8_t t = out[i * 3];
        out[i * 3] = out[i * 3 + 2];
        out[i * 3 + 2] = t;
    }
#endif
    return 0;
}
#endif  // TXR_HAVE_JPEG

#ifdef TXR_HAVE_PNG
// ---- 16-bit grayscale PNG (SURVEY §2.8 item 15). The uint16-millimeter
// PNG is the reference's depth artifact contract
// (the reference's depth_processor.py:905-921 writes it and its
// depth_to_reconstruction.py:85-92 reads it back); this
// codec replaces the cv2 round trip with libpng directly. Pixel parity with
// cv2 is exact (PNG is lossless); tests pin both encode and decode
// directions against cv2.

struct txr_png_mem_reader {
    const uint8_t* data;
    int64_t len;
    int64_t pos;
};

static void txr_png_read_fn(png_structp png, png_bytep out, png_size_t n) {
    txr_png_mem_reader* r = (txr_png_mem_reader*)png_get_io_ptr(png);
    if (r->pos + (int64_t)n > r->len) {
        png_error(png, "txr: truncated PNG stream");
        return;
    }
    memcpy(out, r->data + r->pos, n);
    r->pos += (int64_t)n;
}

struct txr_png_mem_writer {
    uint8_t* buf;
    int64_t cap;
    int64_t pos;  // total bytes produced (may exceed cap: caller re-sizes)
};

static void txr_png_write_fn(png_structp png, png_bytep data, png_size_t n) {
    txr_png_mem_writer* w = (txr_png_mem_writer*)png_get_io_ptr(png);
    if (w->pos + (int64_t)n <= w->cap) {
        memcpy(w->buf + w->pos, data, n);
    }
    w->pos += (int64_t)n;
}

static void txr_png_flush_fn(png_structp) {}

// Probe dims + bit depth/channels. Returns 0 on success.
int txr_png16_dims(const uint8_t* data, int64_t len, int* w, int* h,
                   int* bit_depth, int* channels) {
    if (len < 8 || png_sig_cmp(data, 0, 8)) return -1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return -1; }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -1;
    }
    txr_png_mem_reader r = {data, len, 0};
    png_set_read_fn(png, &r, txr_png_read_fn);
    png_read_info(png, info);
    *w = (int)png_get_image_width(png, info);
    *h = (int)png_get_image_height(png, info);
    *bit_depth = (int)png_get_bit_depth(png, info);
    *channels = (int)png_get_channels(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
}

// Decode a 16-bit single-channel PNG into a caller-provided uint16 buffer
// (native little-endian). Returns 0 on success.
int txr_decode_png16(const uint8_t* data, int64_t len, uint16_t* out,
                     int w, int h) {
    if (len < 8 || png_sig_cmp(data, 0, 8)) return -1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return -1; }
    png_bytep* rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        free(rows);
        png_destroy_read_struct(&png, &info, nullptr);
        return -1;
    }
    txr_png_mem_reader r = {data, len, 0};
    png_set_read_fn(png, &r, txr_png_read_fn);
    png_read_info(png, info);
    if ((int)png_get_image_width(png, info) != w ||
        (int)png_get_image_height(png, info) != h ||
        png_get_bit_depth(png, info) != 16 ||
        png_get_channels(png, info) != 1) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -1;
    }
    png_set_swap(png);  // PNG stores big-endian; host is little-endian
    rows = (png_bytep*)malloc(sizeof(png_bytep) * h);
    if (!rows) { png_destroy_read_struct(&png, &info, nullptr); return -1; }
    for (int y = 0; y < h; ++y) rows[y] = (png_bytep)(out + (int64_t)y * w);
    png_read_image(png, rows);
    free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
}

// Encode a uint16 single-channel image as 16-bit grayscale PNG into a
// caller-provided buffer. Returns the total encoded size in bytes (which may
// exceed cap — the caller then retries with a larger buffer), or -1 on error.
// Compression level 1 matches cv2.imwrite's default speed/size point.
int64_t txr_encode_png16(const uint16_t* img, int w, int h,
                         uint8_t* out, int64_t cap) {
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING,
                                              nullptr, nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_write_struct(&png, nullptr); return -1; }
    png_bytep* rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        free(rows);
        png_destroy_write_struct(&png, &info);
        return -1;
    }
    txr_png_mem_writer wtr = {out, cap, 0};
    png_set_write_fn(png, &wtr, txr_png_write_fn, txr_png_flush_fn);
    png_set_compression_level(png, 1);
    png_set_IHDR(png, info, w, h, 16, PNG_COLOR_TYPE_GRAY,
                 PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
                 PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    png_set_swap(png);
    rows = (png_bytep*)malloc(sizeof(png_bytep) * h);
    if (!rows) { png_destroy_write_struct(&png, &info); return -1; }
    for (int y = 0; y < h; ++y)
        rows[y] = (png_bytep)(img + (int64_t)y * w);
    png_write_image(png, rows);
    png_write_end(png, info);
    free(rows);
    png_destroy_write_struct(&png, &info);
    return wtr.pos;
}
#endif  // TXR_HAVE_PNG

// Feature probe for the python wrapper.
int txr_has_png(void) {
#ifdef TXR_HAVE_PNG
    return 1;
#else
    return 0;
#endif
}

// Feature probe for the python wrapper.
int txr_has_jpeg(void) {
#ifdef TXR_HAVE_JPEG
    return 1;
#else
    return 0;
#endif
}

// Write a binary_little_endian PLY with float32 xyz + uchar rgb.
// xyz: n*3 float32, rgb: n*3 float32 in [0,1] (may be null).
// Returns 0 on success, negative errno-style codes on failure.
int txr_write_ply(const char* path, const float* xyz, const float* rgb,
                  int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;

    char header[256];
    int hl;
    if (rgb) {
        hl = snprintf(header, sizeof(header),
                      "ply\nformat binary_little_endian 1.0\n"
                      "element vertex %lld\n"
                      "property float x\nproperty float y\nproperty float z\n"
                      "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                      "end_header\n",
                      (long long)n);
    } else {
        hl = snprintf(header, sizeof(header),
                      "ply\nformat binary_little_endian 1.0\n"
                      "element vertex %lld\n"
                      "property float x\nproperty float y\nproperty float z\n"
                      "end_header\n",
                      (long long)n);
    }
    if (fwrite(header, 1, hl, f) != (size_t)hl) { fclose(f); return -2; }

    const int64_t kChunk = 1 << 16;  // records per buffered write
    const int rec = rgb ? 15 : 12;
    char* buf = (char*)malloc(kChunk * rec);
    if (!buf) { fclose(f); return -3; }

    for (int64_t start = 0; start < n; start += kChunk) {
        int64_t m = n - start < kChunk ? n - start : kChunk;
        char* p = buf;
        for (int64_t i = 0; i < m; ++i) {
            const float* v = xyz + (start + i) * 3;
            memcpy(p, v, 12);
            p += 12;
            if (rgb) {
                const float* c = rgb + (start + i) * 3;
                for (int k = 0; k < 3; ++k) {
                    float s = c[k] * 255.0f + 0.5f;
                    if (s < 0.f) s = 0.f;
                    if (s > 255.f) s = 255.f;
                    *p++ = (char)(uint8_t)s;
                }
            }
        }
        if (fwrite(buf, 1, m * rec, f) != (size_t)(m * rec)) {
            free(buf); fclose(f); return -4;
        }
    }
    free(buf);
    fclose(f);
    return 0;
}

// Pack XYZ + RGB into PointCloud2-style interleaved records:
// x, y, z float32 + packed-float rgb (r<<16 | g<<8 | b as uint32 bits).
// out must hold n*16 bytes. rgb may be null → 12-byte records.
int txr_pack_xyzrgb(const float* xyz, const float* rgb, int64_t n,
                    uint8_t* out) {
    if (rgb) {
        for (int64_t i = 0; i < n; ++i) {
            memcpy(out + i * 16, xyz + i * 3, 12);
            uint32_t r = (uint32_t)(rgb[i * 3 + 0] * 255.0f + 0.5f);
            uint32_t g = (uint32_t)(rgb[i * 3 + 1] * 255.0f + 0.5f);
            uint32_t b = (uint32_t)(rgb[i * 3 + 2] * 255.0f + 0.5f);
            if (r > 255) r = 255;
            if (g > 255) g = 255;
            if (b > 255) b = 255;
            uint32_t packed = (r << 16) | (g << 8) | b;
            memcpy(out + i * 16 + 12, &packed, 4);
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            memcpy(out + i * 12, xyz + i * 3, 12);
        }
    }
    return 0;
}

// Compact a masked fixed-capacity point set to dense arrays.
// Returns the number of valid points written.
int64_t txr_compact_points(const float* xyz, const float* rgb,
                           const uint8_t* mask, int64_t n,
                           float* out_xyz, float* out_rgb) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i]) {
            memcpy(out_xyz + m * 3, xyz + i * 3, 12);
            if (rgb && out_rgb) memcpy(out_rgb + m * 3, rgb + i * 3, 12);
            ++m;
        }
    }
    return m;
}

}  // extern "C"
