// Native batch loader for Kaldi float-matrix arks (host code, no kernel).
//
// The port's own copy of vae_npvc_tpu/native/ark_loader.cc, with the same C
// ABI. It feeds the training batches of the host loader
// (data/native_loader.py, data/dataset.py): a thread pool inside one
// process does pread()-based windowed reads straight into the caller's batch
// buffer (no copy on the Python side, no interpreter lock held during IO).
//
// Scope: uncompressed 'FM' (float32) matrices plus all three Kaldi compressed
// formats: 'CM ' (per-column piecewise uint8, col-major), 'CM2' (global
// uint16, row-major), 'CM3' (global uint8, row-major), decoded bit for bit
// as data/kaldi_io.py decodes them (same float64 arithmetic, final round to
// float32). Kaldi writes training fbank dirs compressed by default, so
// migrated corpora take this path. Headers are parsed once at open; each
// item read is a windowed pread (contiguous for FM/CM2/CM3; per-column
// strided for CM format 1).
//
// C ABI (ctypes):
//   void* loader_open(const char* feats_scp);           // returns handle/NULL
//   long  loader_num_utts(void*);
//   int   loader_feat_dim(void*);
//   long  loader_num_frames(void*, long idx);
//   int   loader_load_batch(void*, const long* indices, const long* starts,
//                           long n, long crop, float* out, int nthreads);
//   void  loader_close(void*);
//
// loader_open returns NULL for double matrices, range rxspecifiers or mixed
// feature dims; the caller then reads with Python. loader_load_batch fills
// out[n, crop, dim]; rows past the utterance end are zero (the dataset's
// zero-pad contract).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

enum Format : uint8_t { FM = 0, CM1 = 1, CM2 = 2, CM3 = 3 };

struct Item {
  int file_id;
  Format fmt;
  int64_t data_off;   // byte offset of the value payload
  int64_t hdr_off;    // CM1 only: offset of the 8*cols per-column headers
  int32_t rows;
  int32_t cols;
  float min_value;    // CM* global header
  float range_value;
};

struct Loader {
  std::vector<std::string> files;
  std::vector<int> fds;
  std::vector<Item> items;
  int cols = -1;
};

// Parse "path:offset" (no range suffix; ranges are handled by `starts`).
bool split_rx(const std::string& rx, std::string* path, int64_t* off) {
  size_t colon = rx.rfind(':');
  if (colon == std::string::npos || colon == 0) return false;
  const std::string tail = rx.substr(colon + 1);
  if (tail.empty() ||
      tail.find_first_not_of("0123456789") != std::string::npos)
    return false;
  *path = rx.substr(0, colon);
  *off = std::stoll(tail);
  return true;
}

// Read the Kaldi binary header at `off` (FM or CM/CM2/CM3); fill *it.
bool parse_header(int fd, int64_t off, Item* it) {
  unsigned char buf[32];
  // longest header: \0B + "CM2 " + 16-byte GlobalHeader = 22 bytes;
  // FM is 15. Short files (tiny matrices) may return less than 22 — accept
  // any read that covers the header we end up parsing.
  ssize_t got = pread(fd, buf, sizeof buf, off);
  if (got < 15) return false;
  if (buf[0] != 0 || buf[1] != 'B') return false;
  if (buf[2] == 'F' && buf[3] == 'M' && buf[4] == ' ') {
    if (buf[5] != 4 || buf[10] != 4) return false;
    int32_t rows, cols;
    std::memcpy(&rows, buf + 6, 4);
    std::memcpy(&cols, buf + 11, 4);
    if (rows < 0 || cols <= 0) return false;
    it->fmt = FM;
    it->data_off = off + 15;  // 2 flag + 3 token + (1+4)*2 dims
    it->rows = rows;
    it->cols = cols;
    return true;
  }
  if (buf[2] != 'C' || buf[3] != 'M') return false;
  Format fmt;
  int tok_len;
  if (buf[4] == ' ') { fmt = CM1; tok_len = 3; }
  else if (buf[4] == '2' && buf[5] == ' ') { fmt = CM2; tok_len = 4; }
  else if (buf[4] == '3' && buf[5] == ' ') { fmt = CM3; tok_len = 4; }
  else return false;
  const int64_t gh = 2 + tok_len;        // GlobalHeader <ffii>
  if (got < gh + 16) return false;
  int32_t rows, cols;
  std::memcpy(&it->min_value, buf + gh, 4);
  std::memcpy(&it->range_value, buf + gh + 4, 4);
  std::memcpy(&rows, buf + gh + 8, 4);
  std::memcpy(&cols, buf + gh + 12, 4);
  if (rows < 0 || cols <= 0) return false;
  it->fmt = fmt;
  it->rows = rows;
  it->cols = cols;
  if (fmt == CM1) {
    it->hdr_off = off + gh + 16;
    it->data_off = it->hdr_off + 8LL * cols;
  } else {
    it->hdr_off = 0;
    it->data_off = off + gh + 16;
  }
  return true;
}

// uint16 grid -> float64, matching kaldi_io._uint16_to_float exactly.
inline double u16_to_f64(uint16_t p, double minv, double range) {
  return minv + range * (static_cast<double>(p) / 65535.0);
}

// Piecewise-linear uint8 -> float64, matching kaldi_io._char_to_float
// (same operation order so the IEEE double results are bit-identical).
inline double char_to_f64(uint8_t u, double p0, double p25, double p75,
                          double p100) {
  const double v = static_cast<double>(u);
  if (v <= 64.0) return p0 + (p25 - p0) * (v / 64.0);
  if (v <= 192.0) return p25 + (p75 - p25) * ((v - 64.0) / 128.0);
  return p75 + (p100 - p75) * ((v - 192.0) / 63.0);
}

// Decode one item's row window [start, start+take) into dst (take x cols,
// row-major float32). Returns false on IO error.
bool load_window(const Loader* L, const Item& it, long start, long take,
                 float* dst) {
  const int fd = L->fds[it.file_id];
  const long cols = it.cols;
  switch (it.fmt) {
    case FM: {
      ssize_t want = take * cols * sizeof(float);
      return pread(fd, dst, want, it.data_off + start * cols * sizeof(float))
             == want;
    }
    case CM2: {
      std::vector<uint16_t> raw(take * cols);
      ssize_t want = take * cols * 2;
      if (pread(fd, raw.data(), want, it.data_off + start * cols * 2) != want)
        return false;
      const double minv = it.min_value, range = it.range_value;
      for (long i = 0; i < take * cols; ++i)
        dst[i] = static_cast<float>(u16_to_f64(raw[i], minv, range));
      return true;
    }
    case CM3: {
      std::vector<uint8_t> raw(take * cols);
      if (pread(fd, raw.data(), take * cols, it.data_off + start * cols)
          != take * cols)
        return false;
      const double minv = it.min_value, range = it.range_value;
      for (long i = 0; i < take * cols; ++i)
        dst[i] = static_cast<float>(
            minv + range * (static_cast<double>(raw[i]) / 255.0));
      return true;
    }
    case CM1: {
      // per-column uint16 percentile headers, then uint8 data col-major:
      // a row window is one small strided pread per column
      std::vector<uint16_t> hdr(cols * 4);
      if (pread(fd, hdr.data(), cols * 8, it.hdr_off) != cols * 8)
        return false;
      const double minv = it.min_value, range = it.range_value;
      std::vector<uint8_t> colbuf(take);
      for (long c = 0; c < cols; ++c) {
        if (pread(fd, colbuf.data(), take,
                  it.data_off + c * (int64_t)it.rows + start) != take)
          return false;
        const double p0 = u16_to_f64(hdr[c * 4 + 0], minv, range);
        const double p25 = u16_to_f64(hdr[c * 4 + 1], minv, range);
        const double p75 = u16_to_f64(hdr[c * 4 + 2], minv, range);
        const double p100 = u16_to_f64(hdr[c * 4 + 3], minv, range);
        for (long r = 0; r < take; ++r)
          dst[r * cols + c] = static_cast<float>(
              char_to_f64(colbuf[r], p0, p25, p75, p100));
      }
      return true;
    }
  }
  return false;
}

}  // namespace

extern "C" {

void* loader_open(const char* feats_scp) {
  FILE* f = std::fopen(feats_scp, "r");
  if (!f) return nullptr;
  auto* L = new Loader();
  std::unordered_map<std::string, int> file_ids;
  char line[65536];
  while (std::fgets(line, sizeof line, f)) {
    char* sp = std::strchr(line, ' ');
    if (!sp) continue;
    std::string rx(sp + 1);
    while (!rx.empty() && (rx.back() == '\n' || rx.back() == '\r' ||
                           rx.back() == ' '))
      rx.pop_back();
    std::string path;
    int64_t off;
    if (!split_rx(rx, &path, &off)) { delete L; std::fclose(f); return nullptr; }
    auto itf = file_ids.find(path);
    int fid;
    if (itf == file_ids.end()) {
      int fd = open(path.c_str(), O_RDONLY);
      if (fd < 0) { delete L; std::fclose(f); return nullptr; }
      fid = static_cast<int>(L->files.size());
      file_ids.emplace(path, fid);
      L->files.push_back(path);
      L->fds.push_back(fd);
    } else {
      fid = itf->second;
    }
    Item it;
    it.file_id = fid;
    if (!parse_header(L->fds[fid], off, &it)) {
      delete L; std::fclose(f); return nullptr;  // double/range-scp: fallback
    }
    if (L->cols < 0) L->cols = it.cols;
    if (it.cols != L->cols) { delete L; std::fclose(f); return nullptr; }
    L->items.push_back(it);
  }
  std::fclose(f);
  if (L->items.empty()) { delete L; return nullptr; }
  return L;
}

long loader_num_utts(void* h) {
  return static_cast<Loader*>(h)->items.size();
}

int loader_feat_dim(void* h) { return static_cast<Loader*>(h)->cols; }

long loader_num_frames(void* h, long idx) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || idx >= (long)L->items.size()) return -1;
  return L->items[idx].rows;
}

int loader_load_batch(void* h, const long* indices, const long* starts,
                      long n, long crop, float* out, int nthreads) {
  auto* L = static_cast<Loader*>(h);
  const long dim = L->cols;
  std::atomic<long> next(0);
  std::atomic<int> err(0);

  auto work = [&]() {
    for (;;) {
      long b = next.fetch_add(1);
      if (b >= n) return;
      long idx = indices[b];
      if (idx < 0 || idx >= (long)L->items.size()) { err = 1; return; }
      const Item& it = L->items[idx];
      long start = starts[b];
      long take = it.rows - start;
      if (take > crop) take = crop;
      if (take < 0) take = 0;  // start past end: whole window zero-padded
      float* dst = out + b * crop * dim;
      if (take < crop)
        std::memset(dst + take * dim, 0, (crop - take) * dim * sizeof(float));
      if (take > 0 && !load_window(L, it, start, take, dst)) { err = 2; return; }
    }
  };

  if (nthreads <= 1 || n <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    int nt = nthreads < n ? nthreads : static_cast<int>(n);
    ts.reserve(nt);
    for (int i = 0; i < nt; ++i) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load();
}

void loader_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  for (int fd : L->fds) close(fd);
  delete L;
}

}  // extern "C"
