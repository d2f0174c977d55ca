// The port's PNG decoder: libpng on a pool of threads, each PNG decoded
// straight into a caller's buffer as 8-bit BGR rows (the reference reads
// frames with cv2, whose channel order is BGR). PNG decode is the host's
// bottleneck in 4K evaluation, so it runs here without the interpreter lock
// and Python sees filled numpy buffers.
//
// Built with the host C++ compiler by fldrx_torch/ops/_build.py and loaded
// with ctypes; the argument types are read from the prototypes below.
//
//   fldrx_png_probe(path, &w, &h)                          -> 0 on success
//   fldrx_png_decode(path, out, w, h)                      -> 0 on success
//   fldrx_png_decode_batch(paths, n, outs, w, h, threads)  -> failures
//
// Every decode normalises to 8-bit RGB the same way: 16-bit samples keep
// their high byte, a palette expands to RGB, gray below 8 bits scales to 8
// and gray repeats into three channels, alpha (also a tRNS chunk's) is
// dropped, and the channels are written in BGR order: PIL's convert("RGB")
// flipped.

#include <png.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

// Decode one PNG of size expect_w × expect_h into out (w·h·3 bytes).
// Returns 0 on success, 1 if the file cannot be opened, 2 if libpng cannot
// start, 3 on a decode error, 4 on another size, 5 on another row size.
int decode_one(const char* path, uint8_t* out, uint32_t expect_w,
               uint32_t expect_h) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) { fclose(fp); return 2; }
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        fclose(fp);
        return 2;
    }
    std::vector<png_bytep> rows;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);

    uint32_t w = png_get_image_width(png, info);
    uint32_t h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);
    if (w != expect_w || h != expect_h) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 4;
    }
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    bool trns = png_get_valid(png, info, PNG_INFO_tRNS) != 0;
    if (trns) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    // a tRNS chunk's alpha too (fldrx's decoder keeps it and then refuses
    // the file on its row size)
    if ((color & PNG_COLOR_MASK_ALPHA) || trns) png_set_strip_alpha(png);
    png_set_bgr(png);
    png_read_update_info(png, info);

    size_t stride = png_get_rowbytes(png, info);
    if (stride != static_cast<size_t>(w) * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 5;
    }
    rows.resize(h);
    for (uint32_t y = 0; y < h; ++y)
        rows[y] = out + static_cast<size_t>(y) * stride;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
}

}  // namespace

extern "C" int fldrx_png_probe(const char* path, uint32_t* w, uint32_t* h) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (!png || !info) {
        if (png) png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 2;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
}

extern "C" int fldrx_png_decode(const char* path, uint8_t* out, uint32_t w,
                                uint32_t h) {
    return decode_one(path, out, w, h);
}

// Decode n PNGs of one size on min(threads, n) threads; outs[i] holds
// w·h·3 bytes. Returns the number of failed decodes.
extern "C" int fldrx_png_decode_batch(const char** paths, int n,
                                      uint8_t** outs, uint32_t w, uint32_t h,
                                      int threads) {
    if (threads < 1) threads = 1;
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            if (decode_one(paths[i], outs[i], w, h) != 0) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    int nt = threads < n ? threads : n;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return failures.load();
}
