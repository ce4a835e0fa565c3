// Native prefetching PNG dataset loader (the port's own copy of
// okvis_tpu/native/dataloader.cpp, built by okvis_tpu_torch/native).
//
// A pool of decoder threads reads ahead of the consumer, so image decode
// does not stall the VIO pipeline on the host.
//
// C API (ctypes-friendly):
//   void*  loader_create(const char** paths, int n, int n_threads,
//                        int height, int width, int prefetch)
//   int    loader_next(void* h, float* out)   // blocking; returns index or -1
//   void   loader_destroy(void* h)
//   int    decode_png_gray(const char* path, float* out, int h, int w)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 dataloader.cpp -lpng -lpthread -o libokvis_tpu_torch_dataloader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Decode an 8/16-bit PNG to float32 grayscale [0,255]; returns 0 on success.
int decode_gray(const char* path, float* out, int want_h, int want_w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize to 8-bit gray
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if ((int)h != want_h || (int)w != want_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -4;
  }

  std::vector<unsigned char> row(w);
  std::vector<png_bytep> rows(h);
  std::vector<unsigned char> buf((size_t)w * h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = &buf[(size_t)y * w];
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  const size_t n = (size_t)w * h;
  for (size_t i = 0; i < n; ++i) out[i] = (float)buf[i];
  return 0;
}

struct Loader {
  std::vector<std::string> paths;
  int height = 0, width = 0;
  int prefetch = 8;

  std::vector<std::vector<float>> slots;     // ring buffers
  std::vector<int> slot_status;              // 0=empty 1=ready 2=error
  std::atomic<long> next_to_decode{0};
  long next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    const size_t npix = (size_t)height * width;
    std::vector<float> tmp(npix);
    while (!stop.load()) {
      long idx = next_to_decode.fetch_add(1);
      if (idx >= (long)paths.size()) return;
      int rc = decode_gray(paths[idx].c_str(), tmp.data(), height, width);
      int slot = (int)(idx % slots.size());
      std::unique_lock<std::mutex> lk(mu);
      // wait until the slot is free for this index (ring reuse)
      cv_space.wait(lk, [&] {
        return stop.load() || idx - next_to_consume < (long)slots.size();
      });
      if (stop.load()) return;
      if (rc == 0) {
        slots[slot].assign(tmp.begin(), tmp.end());
        slot_status[slot] = 1;
      } else {
        slot_status[slot] = 2;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int n_threads, int height,
                    int width, int prefetch) {
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->height = height;
  L->width = width;
  L->prefetch = prefetch > 0 ? prefetch : 8;
  L->slots.resize(L->prefetch, std::vector<float>((size_t)height * width));
  L->slot_status.assign(L->prefetch, 0);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking: copies the next image (in order) into out. Returns its index,
// -1 at end of stream, -2 on decode error (stream continues after).
int loader_next(void* h, float* out) {
  Loader* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  long idx = L->next_to_consume;
  if (idx >= (long)L->paths.size()) return -1;
  int slot = (int)(idx % L->slots.size());
  L->cv_ready.wait(lk, [&] { return L->stop.load() || L->slot_status[slot] != 0; });
  if (L->stop.load()) return -1;
  int status = L->slot_status[slot];
  if (status == 1)
    std::memcpy(out, L->slots[slot].data(),
                sizeof(float) * (size_t)L->height * L->width);
  L->slot_status[slot] = 0;
  L->next_to_consume = idx + 1;
  L->cv_space.notify_all();
  return status == 1 ? (int)idx : -2;
}

void loader_destroy(void* h) {
  Loader* L = (Loader*)h;
  L->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->cv_ready.notify_all();
    L->cv_space.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

int decode_png_gray(const char* path, float* out, int h, int w) {
  return decode_gray(path, out, h, w);
}

}  // extern "C"
