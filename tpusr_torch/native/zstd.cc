// tpusr_torch zstd frame decoder (RFC 8878), on the host.
//
// tpusr's orbax checkpoints compress twice with zstd: the OCDBT store's
// manifest and B-tree nodes, and every zarr chunk. The port reads them
// without libzstd, so this file decodes a zstd stream itself:
//   * frames with and without a content size, single-segment or windowed,
//     content checksums (XXH64, verified on request), skippable frames and
//     concatenated frames;
//   * raw, RLE and compressed blocks;
//   * literals raw, RLE, Huffman-compressed (one or four streams, weights
//     direct or FSE-compressed) and treeless (the previous block's table);
//   * sequences with each of the three codes in predefined, RLE,
//     FSE-compressed or repeat mode, repeat offsets and overlapping matches.
// Dictionaries are refused. Every malformed input raises an error whose
// message names the field, and nothing reads or writes outside the given
// buffers. CRC32C (the OCDBT files' checksum) is here too.
//
// C ABI only, consumed through ctypes (tpusr_torch/native/zstd.py).

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error(buf);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// ---------------------------------------------------------------------------
// Output: the caller's buffer of fixed capacity, or a growing malloc'd one.

struct Out {
  uint8_t* buf = nullptr;
  size_t len = 0, cap = 0;
  bool owned = false;

  void need(size_t n) {
    if (len + n <= cap) return;
    if (!owned) fail("output exceeds the %zu bytes the frames declare", cap);
    size_t c = cap ? cap : 1 << 16;
    while (c < len + n) c *= 2;
    auto* p = static_cast<uint8_t*>(realloc(buf, c));
    if (!p) fail("out of memory growing the output to %zu bytes", c);
    buf = p;
    cap = c;
  }
};

// ---------------------------------------------------------------------------
// Bit streams. Forward: the FSE table headers (LSB first). Backward: the
// Huffman and FSE payloads, read from the last byte's marker bit down;
// bits below the start read as 0 (the decoders check the end position).

struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits left above the read position

  BackBits(const uint8_t* data, size_t size, const char* what) : p(data), n(size) {
    if (size == 0) fail("%s: empty bitstream", what);
    uint8_t last = data[size - 1];
    if (last == 0) fail("%s: bitstream's last byte has no end marker", what);
    pos = static_cast<int64_t>(size - 1) * 8 + highbit(last);
  }

  inline uint64_t load(int64_t byte) const {  // 8 bytes from `byte`, 0 past the end
    uint64_t v = 0;
    if (byte + 8 <= static_cast<int64_t>(n)) {
      memcpy(&v, p + byte, 8);
    } else if (byte < static_cast<int64_t>(n)) {
      memcpy(&v, p + byte, n - byte);
    }
    return v;
  }

  // bits [pos - nb, pos) as an integer, nb <= 56
  inline uint32_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    uint64_t m = (uint64_t{1} << nb) - 1;
    if (lo >= 0) return static_cast<uint32_t>((load(lo >> 3) >> (lo & 7)) & m);
    if (pos <= 0) return 0;
    return static_cast<uint32_t>((load(0) << (-lo)) & m);
  }
  inline uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ---------------------------------------------------------------------------
// FSE

struct FseCell {
  uint16_t sym;
  uint8_t nb;
  uint16_t base;
};

struct Fse {
  int al = -1;  // accuracy log; -1 = no table yet
  std::vector<FseCell> t;
};

// Distribution header (RFC 8878 4.1.1); returns the bytes it took.
size_t read_ncount(const uint8_t* src, size_t size, int max_sym, int max_al,
                   std::vector<int16_t>& norm, int& al, const char* what) {
  size_t bit = 0;
  auto peek = [&](int nb) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = bit + i;
      if ((b >> 3) < size && (src[b >> 3] >> (b & 7)) & 1) v |= 1u << i;
    }
    return v;
  };
  al = static_cast<int>(peek(4)) + 5;
  bit += 4;
  if (al > max_al) fail("%s: accuracy log %d above %d", what, al, max_al);
  norm.assign(max_sym + 1, 0);
  int remaining = (1 << al) + 1, threshold = 1 << al, nb = al + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        int r = static_cast<int>(peek(2));
        bit += 2;
        n0 += r;
        if (r != 3) break;
      }
      if (n0 > max_sym) fail("%s: zero-run past symbol %d", what, max_sym);
      sym = n0;
      if (sym > max_sym) break;
    }
    int maxv = 2 * threshold - 1 - remaining;
    int count;
    uint32_t low = peek(nb - 1);
    if (static_cast<int>(low) < maxv) {
      count = static_cast<int>(low);
      bit += nb - 1;
    } else {
      count = static_cast<int>(peek(nb));
      if (count >= threshold) count -= maxv;
      bit += nb;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = static_cast<int16_t>(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("%s: probabilities do not sum to 2^%d", what, al);
  size_t used = (bit + 7) >> 3;
  if (used > size) fail("%s: distribution header runs past its %zu bytes", what, size);
  norm.resize(sym);
  return used;
}

void build_fse(Fse& f, const std::vector<int16_t>& norm, int al, const char* what) {
  const int size = 1 << al;
  f.al = al;
  f.t.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("%s: too many low-probability symbols", what);
      f.t[high--].sym = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s] > 0 ? norm[s] : 0;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].sym = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) fail("%s: symbol spread does not close", what);
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[f.t[u].sym]++;
    if (x == 0) fail("%s: cell of a zero-probability symbol", what);
    int nb = al - highbit(x);
    f.t[u].nb = static_cast<uint8_t>(nb);
    f.t[u].base = static_cast<uint16_t>((x << nb) - size);
  }
}

void build_rle(Fse& f, int sym) {
  f.al = 0;
  f.t.assign(1, FseCell{static_cast<uint16_t>(sym), 0, 0});
}

// ---------------------------------------------------------------------------
// Huffman

struct Huf {
  int max_bits = -1;  // -1 = no table yet
  std::vector<uint16_t> t;  // symbol | nbBits << 8
};

// Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t read_huf(Huf& h, const uint8_t* src, size_t size) {
  if (size < 1) fail("huffman: missing tree description");
  uint8_t hb = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (hb >= 128) {
    size_t nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if (used > size) fail("huffman: direct weights run past the block");
    w.resize(nw);
    for (size_t i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {
    used = 1 + hb;
    if (used > size) fail("huffman: compressed weights run past the block");
    std::vector<int16_t> norm;
    int al;
    size_t hdr = read_ncount(src + 1, hb, 255, 6, norm, al, "huffman weights");
    Fse f;
    build_fse(f, norm, al, "huffman weights");
    if (hdr >= hb) fail("huffman: no weight bitstream after its table");
    BackBits br(src + 1 + hdr, hb - hdr, "huffman weights");
    uint32_t s1 = br.read(al), s2 = br.read(al);
    for (;;) {
      if (w.size() >= 255) fail("huffman: more than 255 weights");
      w.push_back(static_cast<uint8_t>(f.t[s1].sym));
      s1 = f.t[s1].base + br.read(f.t[s1].nb);
      if (br.pos < 0) {
        w.push_back(static_cast<uint8_t>(f.t[s2].sym));
        break;
      }
      if (w.size() >= 255) fail("huffman: more than 255 weights");
      w.push_back(static_cast<uint8_t>(f.t[s2].sym));
      s2 = f.t[s2].base + br.read(f.t[s2].nb);
      if (br.pos < 0) {
        w.push_back(static_cast<uint8_t>(f.t[s1].sym));
        break;
      }
    }
  }
  uint32_t total = 0;
  for (uint8_t x : w) {
    if (x > 12) fail("huffman: weight %d above 12", x);
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("huffman: all weights zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("huffman: weights do not complete a tree");
  if (max_bits > 12) fail("huffman: code length %d above 12", max_bits);
  w.push_back(static_cast<uint8_t>(highbit(rest) + 1));
  if (w.size() > 256) fail("huffman: more than 256 symbols");
  // cells: weight 1 first, each symbol 2^(w-1) cells, in symbol order
  std::vector<uint32_t> start(max_bits + 2, 0);
  std::vector<uint32_t> count(max_bits + 2, 0);
  for (uint8_t x : w) ++count[x];
  uint32_t next = 0;
  for (int x = 1; x <= max_bits; ++x) {
    start[x] = next;
    next += count[x] << (x - 1);
  }
  h.max_bits = max_bits;
  h.t.assign(size_t{1} << max_bits, 0);
  for (size_t s = 0; s < w.size(); ++s) {
    int x = w[s];
    if (!x) continue;
    uint32_t len = 1u << (x - 1);
    uint16_t cell = static_cast<uint16_t>(s | ((max_bits + 1 - x) << 8));
    for (uint32_t i = 0; i < len; ++i) h.t[start[x] + i] = cell;
    start[x] += len;
  }
  return used;
}

void huf_stream(const Huf& h, const uint8_t* src, size_t size, uint8_t* dst, size_t n) {
  BackBits br(src, size, "huffman literals");
  const int mb = h.max_bits;
  for (size_t i = 0; i < n; ++i) {
    uint16_t c = h.t[br.peek(mb)];
    dst[i] = static_cast<uint8_t>(c & 0xff);
    br.pos -= c >> 8;
  }
  if (br.pos != 0) fail("huffman literals: stream ends with %lld bits unread",
                        static_cast<long long>(br.pos));
}

// ---------------------------------------------------------------------------
// Frame state and tables

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,  28,  29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51,  59,  67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  Huf huf;
  Fse ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

const Fse& predefined(int which) {  // 0 literal lengths, 1 offsets, 2 match lengths
  static const std::vector<Fse> built = [] {
    std::vector<Fse> t(3);
    build_fse(t[0], std::vector<int16_t>(kLLDefault, kLLDefault + 36), 6, "predefined");
    build_fse(t[1], std::vector<int16_t>(kOFDefault, kOFDefault + 29), 5, "predefined");
    build_fse(t[2], std::vector<int16_t>(kMLDefault, kMLDefault + 53), 6, "predefined");
    return t;
  }();
  return built[which];
}

// ---------------------------------------------------------------------------
// Blocks

size_t read_literals(Frame& fr, const uint8_t* src, size_t size) {
  if (size < 1) fail("literals: empty section");
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, comp = 0, hdr;
  if (type < 2) {
    if (sf == 0 || sf == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (size < 2) fail("literals: header runs past the block");
      regen = (src[0] >> 4) + (size_t{src[1]} << 4);
    } else {
      hdr = 3;
      if (size < 3) fail("literals: header runs past the block");
      regen = (src[0] >> 4) + (size_t{src[1]} << 4) + (size_t{src[2]} << 12);
    }
    fr.lit.resize(regen);
    if (type == 0) {
      if (hdr + regen > size) fail("literals: raw bytes run past the block");
      if (regen) memcpy(fr.lit.data(), src + hdr, regen);
      return hdr + regen;
    }
    if (hdr + 1 > size) fail("literals: RLE byte missing");
    memset(fr.lit.data(), src[hdr], regen);
    return hdr + 1;
  }
  int streams = sf == 0 ? 1 : 4;
  if (sf < 2) {
    hdr = 3;
    if (size < 3) fail("literals: header runs past the block");
    uint32_t v = src[0] | (src[1] << 8) | (src[2] << 16);
    regen = (v >> 4) & 0x3ff;
    comp = (v >> 14) & 0x3ff;
  } else if (sf == 2) {
    hdr = 4;
    if (size < 4) fail("literals: header runs past the block");
    uint32_t v = le32(src);
    regen = (v >> 4) & 0x3fff;
    comp = v >> 18;
  } else {
    hdr = 5;
    if (size < 5) fail("literals: header runs past the block");
    uint64_t v = le32(src) | (uint64_t{src[4]} << 32);
    regen = (v >> 4) & 0x3ffff;
    comp = (v >> 22) & 0x3ffff;
  }
  if (hdr + comp > size) fail("literals: compressed size %zu runs past the block", comp);
  const uint8_t* p = src + hdr;
  size_t left = comp;
  if (type == 2) {
    size_t t = read_huf(fr.huf, p, left);
    p += t;
    left -= t;
  } else if (fr.huf.max_bits < 0) {
    fail("literals: treeless block without an earlier Huffman table");
  }
  fr.lit.resize(regen);
  if (streams == 1) {
    huf_stream(fr.huf, p, left, fr.lit.data(), regen);
  } else {
    if (left < 6) fail("literals: jump table runs past the block");
    size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
    if (6 + s1 + s2 + s3 > left) fail("literals: stream sizes run past the block");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("literals: %zu literals do not fill four streams", regen);
    const uint8_t* q = p + 6;
    uint8_t* d = fr.lit.data();
    huf_stream(fr.huf, q, s1, d, seg);
    huf_stream(fr.huf, q + s1, s2, d + seg, seg);
    huf_stream(fr.huf, q + s1 + s2, s3, d + 2 * seg, seg);
    huf_stream(fr.huf, q + s1 + s2 + s3, s4, d + 3 * seg, regen - 3 * seg);
  }
  return hdr + comp;
}

size_t read_table(Fse& f, int which, int mode, const uint8_t* src, size_t size,
                  int max_sym, int max_al, const char* what) {
  switch (mode) {
    case 0:
      f = predefined(which);
      return 0;
    case 1:
      if (size < 1) fail("%s: RLE symbol missing", what);
      if (src[0] > max_sym) fail("%s: RLE symbol %d above %d", what, src[0], max_sym);
      build_rle(f, src[0]);
      return 1;
    case 2: {
      std::vector<int16_t> norm;
      int al;
      size_t used = read_ncount(src, size, max_sym, max_al, norm, al, what);
      build_fse(f, norm, al, what);
      return used;
    }
    default:
      if (f.al < 0) fail("%s: repeat mode without an earlier table", what);
      return 0;
  }
}

void compressed_block(Frame& fr, const uint8_t* src, size_t size, Out& out, size_t frame_start) {
  size_t p = read_literals(fr, src, size);
  if (p >= size) fail("sequences: section missing");
  size_t nseq = src[p];
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (p + 2 > size) fail("sequences: count runs past the block");
    nseq = ((nseq - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > size) fail("sequences: count runs past the block");
    nseq = src[p + 1] + (size_t{src[p + 2]} << 8) + 0x7f00;
    p += 3;
  }
  const uint8_t* lit = fr.lit.data();
  size_t nlit = fr.lit.size(), li = 0;
  if (nseq > 0) {
    if (p >= size) fail("sequences: compression modes missing");
    uint8_t modes = src[p++];
    if (modes & 3) fail("sequences: reserved mode bits set");
    p += read_table(fr.ll, 0, modes >> 6, src + p, size - p, 35, 9, "literal lengths");
    p += read_table(fr.of, 1, (modes >> 4) & 3, src + p, size - p, 31, 8, "offsets");
    p += read_table(fr.ml, 2, (modes >> 2) & 3, src + p, size - p, 52, 9, "match lengths");
    if (p >= size) fail("sequences: bitstream missing");
    BackBits br(src + p, size - p, "sequences");
    const FseCell* llt = fr.ll.t.data();
    const FseCell* oft = fr.of.t.data();
    const FseCell* mlt = fr.ml.t.data();
    uint32_t sll = br.read(fr.ll.al), sof = br.read(fr.of.al), sml = br.read(fr.ml.al);
    for (size_t i = 0; i < nseq; ++i) {
      const uint32_t llc = llt[sll].sym, ofc = oft[sof].sym, mlc = mlt[sml].sym;
      if (ofc > 31) fail("sequences: offset code %u above 31", ofc);
      uint64_t ofv = (uint64_t{1} << ofc) + br.read(ofc);
      uint32_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      uint32_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = static_cast<uint32_t>(off);
      } else {
        uint32_t idx = static_cast<uint32_t>(ofv) - (ll == 0 ? 0 : 1);
        if (idx == 0) {
          off = fr.rep[0];
        } else {
          off = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
          if (off == 0) fail("sequences: repeat offset 0");
          if (idx != 1) fr.rep[2] = fr.rep[1];
          fr.rep[1] = fr.rep[0];
          fr.rep[0] = static_cast<uint32_t>(off);
        }
      }
      if (i + 1 < nseq) {
        sll = llt[sll].base + br.read(llt[sll].nb);
        sml = mlt[sml].base + br.read(mlt[sml].nb);
        sof = oft[sof].base + br.read(oft[sof].nb);
      }
      if (ll > nlit - li) fail("sequences: literal length %u past the literals", ll);
      out.need(size_t{ll} + ml);
      memcpy(out.buf + out.len, lit + li, ll);
      out.len += ll;
      li += ll;
      if (off > out.len - frame_start) fail("sequences: offset %llu before the frame",
                                            static_cast<unsigned long long>(off));
      uint8_t* d = out.buf + out.len;
      const uint8_t* s = d - off;
      if (off >= ml) {
        memcpy(d, s, ml);
      } else {
        for (uint32_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.len += ml;
    }
    if (br.pos != 0) fail("sequences: bitstream ends with %lld bits unread",
                          static_cast<long long>(br.pos));
  } else if (p != size) {
    fail("sequences: %zu bytes after an empty section", size - p);
  }
  size_t rest = nlit - li;
  out.need(rest);
  if (rest) memcpy(out.buf + out.len, lit + li, rest);
  out.len += rest;
}

// ---------------------------------------------------------------------------
// XXH64 (the frame checksum) and CRC32C

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t merge64(uint64_t acc, uint64_t v) {
  acc ^= round64(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      uint64_t x[4];
      memcpy(x, p, 32);
      v1 = round64(v1, x[0]);
      v2 = round64(v2, x[1]);
      v3 = round64(v3, x[2]);
      v4 = round64(v4, x[3]);
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    uint64_t k;
    memcpy(&k, p, 8);
    h ^= round64(0, k);
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t{le32(p)} * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= *p++ * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Frames

struct Header {
  bool skippable = false;
  size_t size = 0;           // header bytes (skippable: the whole frame)
  int64_t content = -1;      // declared content size, -1 if absent
  bool checksum = false;
};

Header read_header(const uint8_t* src, size_t n) {
  Header h;
  if (n < 4) fail("frame: %zu bytes, too short for a magic number", n);
  uint32_t magic = le32(src);
  if ((magic & 0xfffffff0u) == 0x184d2a50u) {
    if (n < 8) fail("skippable frame: size field missing");
    h.skippable = true;
    h.size = 8 + size_t{le32(src + 4)};
    if (h.size > n) fail("skippable frame: %zu bytes run past the input", h.size);
    return h;
  }
  if (magic != 0xfd2fb528u) fail("frame: bad magic number 0x%08x", magic);
  if (n < 5) fail("frame: header descriptor missing");
  uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("frame: reserved descriptor bit set");
  h.checksum = (fhd >> 2) & 1;
  size_t p = 5 + (single ? 0 : 1);
  const int dict_bytes[4] = {0, 1, 2, 4};
  const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
  size_t need = p + dict_bytes[dict_flag] + fcs_bytes[fcs_flag];
  if (need > n) fail("frame: header runs past the input");
  uint32_t dict = 0;
  for (int i = 0; i < dict_bytes[dict_flag]; ++i) dict |= uint32_t{src[p + i]} << (8 * i);
  if (dict) fail("frame: dictionary %u; dictionaries are not supported", dict);
  p += dict_bytes[dict_flag];
  if (fcs_bytes[fcs_flag]) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes[fcs_flag]; ++i) v |= uint64_t{src[p + i]} << (8 * i);
    if (fcs_flag == 1) v += 256;
    h.content = static_cast<int64_t>(v);
    p += fcs_bytes[fcs_flag];
  }
  h.size = p;
  return h;
}

// One frame at src; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, Out& out, bool verify) {
  Header h = read_header(src, n);
  if (h.skippable) return h.size;
  size_t p = h.size;
  const size_t start = out.len;
  if (h.content >= 0) out.need(static_cast<size_t>(h.content));
  Frame fr;
  for (;;) {
    if (p + 3 > n) fail("block: header runs past the input");
    uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bs = bh >> 3;
    if (bs > (1u << 17)) fail("block: size %zu above 128 KiB", bs);
    if (type == 0) {
      if (p + bs > n) fail("raw block: runs past the input");
      out.need(bs);
      memcpy(out.buf + out.len, src + p, bs);
      out.len += bs;
      p += bs;
    } else if (type == 1) {
      if (p + 1 > n) fail("RLE block: byte missing");
      out.need(bs);
      memset(out.buf + out.len, src[p], bs);
      out.len += bs;
      p += 1;
    } else if (type == 2) {
      if (p + bs > n) fail("compressed block: runs past the input");
      compressed_block(fr, src + p, bs, out, start);
      p += bs;
    } else {
      fail("block: reserved block type 3");
    }
    if (last) break;
  }
  if (h.content >= 0 && out.len - start != static_cast<size_t>(h.content))
    fail("frame: %zu bytes decoded, header declares %lld", out.len - start,
         static_cast<long long>(h.content));
  if (h.checksum) {
    if (p + 4 > n) fail("frame: checksum missing");
    if (verify) {
      uint32_t want = le32(src + p);
      uint32_t got = static_cast<uint32_t>(xxh64(out.buf + start, out.len - start));
      if (want != got) fail("frame: checksum 0x%08x, content hashes to 0x%08x", want, got);
    }
    p += 4;
  }
  return p;
}

void decode_all(const uint8_t* src, size_t n, Out& out, bool verify) {
  size_t p = 0;
  if (n == 0) fail("input: no frame");
  while (p < n) p += decode_frame(src + p, n - p, out, verify);
}

void set_err(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    strncpy(err, msg, cap - 1);
    err[cap - 1] = 0;
  }
}

uint32_t crc_table[8][256];

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82f63b78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xff];
}

}  // namespace

extern "C" {

// Total content size of every frame, when each declares one; -1 when one
// does not; -2 on a malformed header (message in err).
int64_t tpusr_zstd_content_size(const uint8_t* src, size_t n, char* err, size_t errcap) {
  try {
    int64_t total = 0;
    size_t p = 0;
    if (n == 0) fail("input: no frame");
    while (p < n) {
      Header h = read_header(src + p, n - p);
      if (h.skippable) {
        p += h.size;
        continue;
      }
      if (h.content < 0) return -1;
      total += h.content;
      // walk the blocks to the next frame
      size_t q = p + h.size;
      for (;;) {
        if (q + 3 > n) fail("block: header runs past the input");
        uint32_t bh = src[q] | (src[q + 1] << 8) | (src[q + 2] << 16);
        const int type = (bh >> 1) & 3;
        q += 3 + (type == 1 ? 1 : bh >> 3);
        if (bh & 1) break;
      }
      p = q + (h.checksum ? 4 : 0);
      if (p > n) fail("frame: runs past the input");
    }
    return total;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -2;
  }
}

// Decode every frame into dst (cap bytes); the bytes written, or -1 with
// the message in err.
int64_t tpusr_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                              int verify, char* err, size_t errcap) {
  Out out;
  out.buf = dst;
  out.cap = cap;
  try {
    decode_all(src, n, out, verify != 0);
    return static_cast<int64_t>(out.len);
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}

// As tpusr_zstd_decompress, into a buffer it allocates (*dst, released
// with tpusr_zstd_free), for frames that declare no content size.
int64_t tpusr_zstd_decompress_alloc(const uint8_t* src, size_t n, uint8_t** dst, int verify,
                                    char* err, size_t errcap) {
  Out out;
  out.owned = true;
  *dst = nullptr;
  try {
    decode_all(src, n, out, verify != 0);
    *dst = out.buf;
    return static_cast<int64_t>(out.len);
  } catch (const std::exception& e) {
    free(out.buf);
    set_err(err, errcap, e.what());
    return -1;
  }
}

void tpusr_zstd_free(uint8_t* p) { free(p); }

uint32_t tpusr_crc32c(const uint8_t* p, size_t n) {
  static const bool ready = (crc_init(), true);
  (void)ready;
  uint32_t c = 0xffffffffu;
  while (n >= 8) {
    uint32_t lo = le32(p) ^ c, hi = le32(p + 4);
    c = crc_table[7][lo & 0xff] ^ crc_table[6][(lo >> 8) & 0xff] ^
        crc_table[5][(lo >> 16) & 0xff] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
        crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc_table[0][(c ^ *p++) & 0xff];
  return c ^ 0xffffffffu;
}

}  // extern "C"
