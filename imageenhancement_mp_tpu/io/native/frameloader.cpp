// Native frame loader: multithreaded, order-preserving prefetch of image
// frames from disk into caller buffers.
//
// The reference's data path is cv2.imread inside a per-image Python loop
// (SURVEY.md §3.5) — its decode work happens in OpenCV's C++.  This is the
// rebuild's native equivalent for the streaming runtime (config 5): worker
// threads read + decode frames ahead of the consumer so host IO overlaps
// the device compute that pipeline.stream_frames keeps in flight.
//
// Formats: PGM (P5), PPM (P6) with maxval up to 65535 (2-byte big-endian
// samples above 255, per the PNM spec), 8- or 16-bit non-interlaced
// gray/RGB/RGBA PNG (zlib inflate + unfilter), baseline/progressive JPEG
// (libjpeg), and raw .u8 blobs.  16-bit frames are emitted as host-endian
// uint16 sample bytes with *depth = 16.  Dependencies: zlib, libjpeg.
//
// C ABI (ctypes-friendly):
//   void* fl_create(const char** paths, int n, int threads, long max_bytes)
//   long  fl_next(void* h, unsigned char* out, long cap,
//                 int* w, int* hgt, int* ch, int* depth)
//         // frame bytes, 0 = end, <0 = error (the stream continues past a
//         // failed frame: call fl_next again for the next index)
//   void  fl_destroy(void* h)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#include <csetjmp>
#include <jpeglib.h>

namespace {

struct Frame {
  std::vector<uint8_t> data;
  int w = 0, h = 0, ch = 0;
  int depth = 8;  // bits per sample: 8 (uint8) or 16 (host-endian uint16)
  long err = 0;   // <0 on failure
};

// Big-endian sample bytes -> host-endian uint16 bytes, in place.
static void be16_to_host(std::vector<uint8_t>& data) {
  const uint16_t one = 1;
  if (*reinterpret_cast<const uint8_t*>(&one) == 0) return;  // big-endian host
  for (size_t i = 0; i + 1 < data.size(); i += 2) std::swap(data[i], data[i + 1]);
}

struct Loader {
  std::vector<std::string> paths;
  long max_bytes;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Frame> ready;   // decoded frames by index
  size_t next_fetch = 0;           // next index a worker should take
  size_t next_emit = 0;            // next index the consumer expects
  size_t queue_cap;
  bool stopping = false;
};

// Skip PNM whitespace and '#' comments.
static void skip_ws(FILE* f) {
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!isspace(c)) {
      ungetc(c, f);
      return;
    }
  }
}

static bool read_int(FILE* f, long* out) {
  skip_ws(f);
  long v = 0;
  int c = fgetc(f);
  if (c < '0' || c > '9') return false;
  while (c >= '0' && c <= '9') {
    v = v * 10 + (c - '0');
    if (v > (1L << 26)) return false;  // bound before overflow (max dim/val)
    c = fgetc(f);
  }
  if (c != EOF) ungetc(c, f);  // leave the terminator for the caller
  *out = v;
  return true;
}

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// 8/16-bit non-interlaced gray(0)/RGB(2)/RGBA(6)/gray+alpha(4) PNG decode.
static void decode_png(const std::vector<uint8_t>& file, long max_bytes, Frame* fr) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 45 || memcmp(file.data(), sig, 8) != 0) {
    fr->err = -6;
    return;
  }
  size_t pos = 8;
  long w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0, ch = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (pos + 12 + len > file.size()) {
      fr->err = -6;
      return;
    }
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    if (!memcmp(type, "IHDR", 4)) {
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  switch (color_type) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: fr->err = -7; return;  // paletted etc. unsupported
  }
  if ((bit_depth != 8 && bit_depth != 16) || interlace != 0 || w <= 0 ||
      h <= 0 || w > (1 << 24) || h > (1 << 24)) {
    fr->err = -7;
    return;
  }
  int bpp = ch * (bit_depth / 8);  // filter left-offset = bytes per pixel
  // computed in long long with pre-checked dims so a crafted IHDR cannot
  // wrap the size checks and abort the process via std::length_error
  long long stride = static_cast<long long>(w) * bpp;
  long long raw_len = (stride + 1) * h;
  if (stride * h > max_bytes || raw_len > (1LL << 40)) {
    fr->err = -4;
    return;
  }
  std::vector<uint8_t> raw(raw_len);
  uLongf dst_len = raw_len;
  if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
      dst_len != static_cast<uLongf>(raw_len)) {
    fr->err = -8;
    return;
  }
  fr->data.resize(stride * h);
  std::vector<uint8_t> prev(stride, 0);
  for (long y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &fr->data[y * stride];
    for (long x = 0; x < stride; ++x) {
      int a = x >= bpp ? dst[x - bpp] : 0;       // left
      int b = prev[x];                           // up
      int c = x >= bpp ? prev[x - bpp] : 0;      // up-left
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: fr->err = -9; return;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
    memcpy(prev.data(), dst, stride);
  }
  if (bit_depth == 16) be16_to_host(fr->data);  // PNG samples are big-endian
  fr->w = static_cast<int>(w);
  fr->h = static_cast<int>(h);
  fr->ch = ch;
  fr->depth = bit_depth;
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Baseline/progressive JPEG via libjpeg; gray stays 1ch, color -> RGB.
static void decode_jpeg(const std::vector<uint8_t>& file, long max_bytes, Frame* fr) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fr->err = -10;
    fr->data.clear();
    return;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(file.data()), file.size());
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = cinfo.num_components == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  long long w = cinfo.output_width, h = cinfo.output_height, ch = cinfo.output_components;
  long long bytes = w * h * ch;
  if (w <= 0 || h <= 0 || w > (1 << 24) || h > (1 << 24) || bytes > max_bytes) {
    jpeg_destroy_decompress(&cinfo);
    fr->err = -4;
    return;
  }
  fr->data.resize(bytes);
  long long stride = w * ch;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = fr->data.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fr->w = static_cast<int>(w);
  fr->h = static_cast<int>(h);
  fr->ch = static_cast<int>(ch);
}

static void decode(const std::string& path, long max_bytes, Frame* fr) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    fr->err = -2;
    return;
  }
  int c0 = fgetc(f), c1 = fgetc(f);
  if (c0 == 'P' && (c1 == '5' || c1 == '6')) {
    long w, h, maxv;
    if (!read_int(f, &w) || !read_int(f, &h) || !read_int(f, &maxv) ||
        maxv < 1 || maxv > 65535) {
      fr->err = -3;
      fclose(f);
      return;
    }
    fgetc(f);  // single whitespace after maxval
    if (w <= 0 || h <= 0 || w > (1 << 24) || h > (1 << 24)) {
      fr->err = -3;
      fclose(f);
      return;
    }
    int ch = (c1 == '6') ? 3 : 1;
    int depth = maxv > 255 ? 16 : 8;  // PNM spec: 2-byte BE samples above 255
    long long bytes = static_cast<long long>(w) * h * ch * (depth / 8);
    if (bytes <= 0 || bytes > max_bytes) {
      fr->err = -4;
      fclose(f);
      return;
    }
    fr->data.resize(static_cast<size_t>(bytes));
    if (fread(fr->data.data(), 1, bytes, f) != static_cast<size_t>(bytes)) {
      fr->err = -5;
      fclose(f);
      return;
    }
    if (depth == 16) be16_to_host(fr->data);
    fr->w = static_cast<int>(w);
    fr->h = static_cast<int>(h);
    fr->ch = ch;
    fr->depth = depth;
  } else {
    // whole-file formats: PNG, or raw blob (shape unknown; w=h=ch=0)
    fseek(f, 0, SEEK_END);
    long bytes = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (bytes <= 0 || bytes > max_bytes * 2) {  // compressed may exceed decoded cap
      fr->err = -4;
      fclose(f);
      return;
    }
    std::vector<uint8_t> file(bytes);
    if (fread(file.data(), 1, bytes, f) != static_cast<size_t>(bytes)) {
      fr->err = -5;
      fclose(f);
      return;
    }
    if (bytes > 8 && file[0] == 137 && file[1] == 'P' && file[2] == 'N' &&
        file[3] == 'G') {
      decode_png(file, max_bytes, fr);
    } else if (bytes > 3 && file[0] == 0xFF && file[1] == 0xD8 && file[2] == 0xFF) {
      decode_jpeg(file, max_bytes, fr);
    } else if (bytes <= max_bytes) {
      fr->data = std::move(file);
    } else {
      fr->err = -4;
    }
  }
  fclose(f);
}

static void worker(Loader* L) {
  for (;;) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      // bound read-ahead: don't run more than queue_cap past the consumer
      L->cv_space.wait(lk, [&] {
        return L->stopping || (L->next_fetch < L->paths.size() &&
                               L->next_fetch < L->next_emit + L->queue_cap);
      });
      if (L->stopping || L->next_fetch >= L->paths.size()) return;
      idx = L->next_fetch++;
    }
    Frame fr;
    decode(L->paths[idx], L->max_bytes, &fr);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->ready.emplace(idx, std::move(fr));
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* fl_create(const char** paths, int n, int threads, long max_bytes) {
  if (n < 0 || threads < 1) return nullptr;
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->max_bytes = max_bytes;
  L->queue_cap = static_cast<size_t>(threads) * 2 + 2;
  for (int i = 0; i < threads; ++i) L->workers.emplace_back(worker, L);
  return L;
}

long fl_next(void* handle, unsigned char* out, long cap, int* w, int* h, int* ch,
             int* depth) {
  auto* L = static_cast<Loader*>(handle);
  size_t idx;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->next_emit >= L->paths.size()) return 0;  // end of stream
    idx = L->next_emit;
  }
  Frame fr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->ready.count(idx) > 0; });
    fr = std::move(L->ready[idx]);
    L->ready.erase(idx);
    L->next_emit++;
  }
  L->cv_space.notify_all();
  if (fr.err < 0) return fr.err;
  long bytes = static_cast<long>(fr.data.size());
  if (bytes > cap) return -1;
  memcpy(out, fr.data.data(), bytes);
  *w = fr.w;
  *h = fr.h;
  *ch = fr.ch;
  *depth = fr.depth;
  return bytes;
}

void fl_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
