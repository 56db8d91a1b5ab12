// Host-side image decoding: JPEG (libjpeg) + PNG (libpng) -> BGR uint8.
//
// The port's copy of the JAX package's decoder (the same source, so both
// packages decode a file to the same bytes).  It replaces the reference's
// OpenCV imgcodecs JNI decode (ImageReader.scala:25-40: Imgcodecs.imdecode
// per row inside a Spark UDF).  Decode stays on the host (bitstream parsing
// is scalar); the decoded tensors then batch onto the device for every
// later op.  Output is BGR to keep the reference's OpenCV byte order
// (ImageSchema.scala:18-23).
//
// Exposed as a plain C ABI consumed via ctypes
// (mmlspark_tpu_torch/native_loader.py, cf. NativeLoader.java:29-159).

#include <cstdint>
#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void jpeg_silence(j_common_ptr, int) {}

bool is_jpeg(const unsigned char* buf, int64_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

bool is_png(const unsigned char* buf, int64_t len) {
  return len >= 8 && png_sig_cmp(buf, 0, 8) == 0;
}

}  // namespace

extern "C" {

// Probe dimensions. Returns 0 on success, fills (width, height, channels);
// channels is what decode_image will produce (3 = BGR, 1 = gray).
int image_dims(const unsigned char* buf, int64_t len, int* width, int* height,
               int* channels) {
  if (is_jpeg(buf, len)) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    jerr.pub.emit_message = jpeg_silence;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
                 static_cast<uint64_t>(len));
    jpeg_read_header(&cinfo, TRUE);
    *width = static_cast<int>(cinfo.image_width);
    *height = static_cast<int>(cinfo.image_height);
    *channels = cinfo.num_components == 1 ? 1 : 3;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  if (is_png(buf, len)) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, buf,
                                          static_cast<size_t>(len))) {
      return -1;
    }
    *width = static_cast<int>(image.width);
    *height = static_cast<int>(image.height);
    *channels = (image.format & PNG_FORMAT_FLAG_COLOR) ? 3 : 1;
    png_image_free(&image);
    return 0;
  }
  return -2;  // unknown format
}

// Decode into caller-allocated out (height*width*channels bytes, BGR or
// gray row-major). Returns 0 on success.
int decode_image(const unsigned char* buf, int64_t len, unsigned char* out,
                 int width, int height, int channels) {
  if (is_jpeg(buf, len)) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    jerr.pub.emit_message = jpeg_silence;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
                 static_cast<uint64_t>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_width) != width ||
        static_cast<int>(cinfo.output_height) != height) {
      jpeg_destroy_decompress(&cinfo);
      return -3;
    }
    const int row_bytes = width * channels;
    while (cinfo.output_scanline < cinfo.output_height) {
      unsigned char* row = out +
          static_cast<int64_t>(cinfo.output_scanline) * row_bytes;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    if (channels == 3) {  // RGB -> BGR in place
      const int64_t n = static_cast<int64_t>(width) * height;
      for (int64_t i = 0; i < n; ++i) {
        unsigned char t = out[i * 3];
        out[i * 3] = out[i * 3 + 2];
        out[i * 3 + 2] = t;
      }
    }
    return 0;
  }
  if (is_png(buf, len)) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, buf,
                                          static_cast<size_t>(len))) {
      return -1;
    }
    image.format = channels == 1 ? PNG_FORMAT_GRAY : PNG_FORMAT_BGR;
    if (static_cast<int>(image.width) != width ||
        static_cast<int>(image.height) != height) {
      png_image_free(&image);
      return -3;
    }
    // Alpha channels composite against the existing buffer contents when no
    // background is given; zero it so transparent regions are black, not
    // whatever the caller's uninitialized allocation held.
    memset(out, 0, static_cast<size_t>(width) * height * channels);
    if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
      png_image_free(&image);
      return -1;
    }
    return 0;
  }
  return -2;
}

// Parallel batch decode: n independent buffers decoded by a thread pool
// (libjpeg/libpng handles are per-call, so decodes are embarrassingly
// parallel; the Python caller holds the GIL exactly once for the whole
// batch instead of once per image).  outs[i] must be pre-allocated to
// heights[i]*widths[i]*channels[i] bytes (probe with image_dims first).
// status[i] receives each image's decode_image return code; the function
// returns the number of failures.
int decode_batch(const unsigned char** bufs, const int64_t* lens,
                 unsigned char** outs, const int* widths, const int* heights,
                 const int* channels, int n, int n_threads, int* status) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      status[i] = decode_image(bufs[i], lens[i], outs[i], widths[i],
                               heights[i], channels[i]);
      if (status[i] != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads) - 1);
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
