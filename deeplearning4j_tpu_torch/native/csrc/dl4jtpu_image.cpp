// Native image pipeline: threaded JPEG/PNG decode + bilinear resize feeding
// float32 NHWC batches.
//
// The port's copy of deeplearning4j_tpu/native/csrc/dl4jtpu_image.cpp: the
// same decode, the same bilinear resize, the same failure markers. One
// wake-up is repaired as in dl4jtpu_native.cpp: a worker counts itself done,
// and img_pipe_destroy sets `stop`, under the mutex, so a consumer between
// its check and its wait cannot miss either.
//
// Reference parity: datavec-data-image NativeImageLoader.java (JavaCPP
// OpenCV decode straight into off-heap INDArray buffers) + the
// AsyncDataSetIterator prefetch thread — path-cite, mount empty this round.
// The TPU build decodes with the system libjpeg/libpng on C++ threads that
// never touch the Python GIL; the consumer copies ready images into one
// batch buffer (page-locked on a CUDA host) that is copied to the card.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct DecodedImage {
  std::vector<uint8_t> pixels;  // HWC uint8
  int w = 0, h = 0, c = 0;
};

// ---------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, int want_c, DecodedImage* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = want_c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = cinfo.output_components;
  out->pixels.resize(size_t(out->w) * out->h * out->c);
  size_t stride = size_t(out->w) * out->c;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->pixels.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG

bool decode_png(const uint8_t* buf, size_t len, int want_c, DecodedImage* out) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) return false;
  image.format = want_c == 1 ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  out->w = image.width;
  out->h = image.height;
  out->c = want_c == 1 ? 1 : 3;
  out->pixels.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->pixels.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

bool decode_any(const uint8_t* buf, size_t len, int want_c, DecodedImage* out) {
  if (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8)
    return decode_jpeg(buf, len, want_c, out);
  if (len > 8 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' && buf[3] == 'G')
    return decode_png(buf, len, want_c, out);
  return false;
}

// -------------------------------------------------------------- resize

// bilinear uint8 HWC → float32 HWC (align-corners=false, PIL-like sampling)
void resize_bilinear_f32(const DecodedImage& img, int oh, int ow, float* out) {
  const int c = img.c;
  const float sy = float(img.h) / oh;
  const float sx = float(img.w) / ow;
  for (int y = 0; y < oh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    float wy = fy - y0;
    for (int x = 0; x < ow; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
      float wx = fx - x0;
      const uint8_t* p00 = img.pixels.data() + (size_t(y0) * img.w + x0) * c;
      const uint8_t* p01 = img.pixels.data() + (size_t(y0) * img.w + x1) * c;
      const uint8_t* p10 = img.pixels.data() + (size_t(y1) * img.w + x0) * c;
      const uint8_t* p11 = img.pixels.data() + (size_t(y1) * img.w + x1) * c;
      float* o = out + (size_t(y) * ow + x) * c;
      for (int k = 0; k < c; k++) {
        float top = p00[k] + (p01[k] - p00[k]) * wx;
        float bot = p10[k] + (p11[k] - p10[k]) * wx;
        o[k] = top + (bot - top) * wy;
      }
    }
  }
}

struct ImgBatch {
  float* data;   // (H, W, C)
  int label;
  int idx;
  int status;    // 0 ok, -1 decode failure, -2 unreadable
};

struct ImgPipeline {
  std::vector<std::string> paths;
  std::vector<int> labels;
  int oh, ow, c;
  size_t capacity;
  std::deque<ImgBatch> ready;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<int> next_file{0};
  std::atomic<int> done_workers{0};
  std::atomic<bool> stop{false};
  int n_threads;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int idx = next_file.fetch_add(1);
      if (idx >= (int)paths.size() || stop.load()) break;
      ImgBatch b{nullptr, labels[idx], idx, 0};
      std::ifstream f(paths[idx], std::ios::binary | std::ios::ate);
      if (!f) {
        b.status = -2;
      } else {
        size_t len = f.tellg();
        f.seekg(0);
        std::vector<uint8_t> buf(len);
        f.read(reinterpret_cast<char*>(buf.data()), len);
        DecodedImage img;
        if (!decode_any(buf.data(), len, c, &img) || img.c != c) {
          b.status = -1;
        } else {
          b.data = static_cast<float*>(
              malloc(sizeof(float) * size_t(oh) * ow * c));
          resize_bilinear_f32(img, oh, ow, b.data);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return ready.size() < capacity || stop.load(); });
      if (stop.load()) {
        if (b.data) free(b.data);
        return;
      }
      ready.push_back(b);
      cv_pop.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    done_workers.fetch_add(1);
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

// Decode + resize ONE file → float32 HWC into caller buffer. 0 ok.
int image_decode_file(const char* path, int oh, int ow, int c, float* out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return -2;
  size_t len = f.tellg();
  f.seekg(0);
  std::vector<uint8_t> buf(len);
  f.read(reinterpret_cast<char*>(buf.data()), len);
  DecodedImage img;
  if (!decode_any(buf.data(), len, c, &img) || img.c != c) return -1;
  resize_bilinear_f32(img, oh, ow, out);
  return 0;
}

void* img_pipe_create(const char** paths, const int* labels, int n,
                      int oh, int ow, int c, int n_threads, int capacity) {
  ImgPipeline* p = new ImgPipeline();
  for (int i = 0; i < n; i++) {
    p->paths.emplace_back(paths[i]);
    p->labels.push_back(labels ? labels[i] : -1);
  }
  p->oh = oh;
  p->ow = ow;
  p->c = c;
  p->capacity = capacity > 0 ? capacity : 8;
  p->n_threads = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < p->n_threads; t++)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Copy up to max_n ready images into out (max_n, oh, ow, c) + labels/indices.
// → n copied (0 = exhausted); decode failures are SKIPPED and counted in
// *n_failed.
long img_pipe_next_batch(void* pipe, float* out, int* labels_out,
                         int* indices_out, long max_n, int* n_failed) {
  ImgPipeline* p = static_cast<ImgPipeline*>(pipe);
  long n = 0;
  *n_failed = 0;
  size_t img_floats = size_t(p->oh) * p->ow * p->c;
  while (n < max_n) {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] {
      return !p->ready.empty() || p->done_workers.load() == p->n_threads;
    });
    if (p->ready.empty()) break;  // exhausted
    ImgBatch b = p->ready.front();
    p->ready.pop_front();
    p->cv_push.notify_one();
    lk.unlock();
    if (b.status != 0) {
      (*n_failed)++;
      continue;
    }
    memcpy(out + n * img_floats, b.data, sizeof(float) * img_floats);
    if (labels_out) labels_out[n] = b.label;
    if (indices_out) indices_out[n] = b.idx;
    free(b.data);
    n++;
  }
  return n;
}

void img_pipe_destroy(void* pipe) {
  ImgPipeline* p = static_cast<ImgPipeline*>(pipe);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
    p->cv_push.notify_all();
    p->cv_pop.notify_all();
  }
  for (auto& t : p->workers) t.join();
  for (auto& b : p->ready)
    if (b.data) free(b.data);
  delete p;
}

}  // extern "C"
