// From-scratch LASzip (.laz) point codec — no third-party code.
//
// Reference parity: the reference reads .laz through PDAL
// (slamio/PointCloudReaderPdal.cpp); PDAL is unavailable here, so this
// implements the LASzip container itself (pointwise-chunked compressor 2,
// record version 2 item codecs: POINT10 / GPSTIME11 / RGB12 / BYTE) against
// the public LASzip specification: an adaptive binary/multi-symbol
// arithmetic coder (Said's FastAC scheme, as specified by LASzip), k-bit
// corrector "IntegerCompressor" models, streaming-median XY prediction and
// multi-sequence GPS-time prediction.  Compressor and decompressor are
// exact mirrors; tests pin lossless round-trips over adversarial inputs
// (tests/test_laz.py).  LAS 1.4 layered point formats (6+) use the v3/v4
// codecs and are not supported — callers get a clear error.
//
// Everything operates on in-memory buffers (the Python side owns file IO
// and LAS/VLR header parsing — ohm_tpu/io/las.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

// ------------------------------------------------------------------------ //
// Adaptive models (FastAC scheme; constants fixed by the LASzip spec).

constexpr U32 AC_MIN_LENGTH = 0x01000000u;
constexpr U32 AC_MAX_LENGTH = 0xFFFFFFFFu;
constexpr U32 BM_LENGTH_SHIFT = 13;
constexpr U32 BM_MAX_COUNT = 1u << BM_LENGTH_SHIFT;
constexpr U32 DM_LENGTH_SHIFT = 15;
constexpr U32 DM_MAX_COUNT = 1u << DM_LENGTH_SHIFT;

struct BitModel {
  U32 bit_0_prob = 0, bit_0_count = 0, bit_count = 0;
  U32 update_cycle = 0, bits_until_update = 0;

  void init() {
    bit_0_count = 1;
    bit_count = 2;
    bit_0_prob = 1u << (BM_LENGTH_SHIFT - 1);
    update_cycle = bits_until_update = 4;
  }
  void update() {
    if ((bit_count += update_cycle) > BM_MAX_COUNT) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    const U32 scale = 0x80000000u / bit_count;
    bit_0_prob = (bit_0_count * scale) >> (31 - BM_LENGTH_SHIFT);
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct SymbolModel {
  U32* distribution = nullptr;  // 2*symbols (+ table) allocation
  U32* symbol_count = nullptr;
  U32* decoder_table = nullptr;
  U32 symbols = 0, last_symbol = 0, table_size = 0, table_shift = 0;
  U32 total_count = 0, update_cycle = 0, symbols_until_update = 0;
  bool compress = false;

  ~SymbolModel() { delete[] distribution; }

  void setup(U32 n, bool for_compress) {
    symbols = n;
    compress = for_compress;
    last_symbol = n - 1;
    delete[] distribution;
    if (!compress && symbols > 16) {
      U32 table_bits = 3;
      while (symbols > (1u << (table_bits + 2))) ++table_bits;
      table_size = 1u << table_bits;
      table_shift = DM_LENGTH_SHIFT - table_bits;
      distribution = new U32[2 * symbols + table_size + 2];
      decoder_table = distribution + 2 * symbols;
    } else {
      decoder_table = nullptr;
      table_size = table_shift = 0;
      distribution = new U32[2 * symbols];
    }
    symbol_count = distribution + symbols;
  }

  void init() {
    total_count = 0;
    update_cycle = symbols;
    for (U32 k = 0; k < symbols; ++k) symbol_count[k] = 1;
    update();
    symbols_until_update = update_cycle = (symbols + 6) >> 1;
  }

  void update() {
    if ((total_count += update_cycle) > DM_MAX_COUNT) {
      total_count = 0;
      for (U32 n = 0; n < symbols; ++n) {
        total_count += (symbol_count[n] = (symbol_count[n] + 1) >> 1);
      }
    }
    U32 sum = 0, s = 0;
    const U32 scale = 0x80000000u / total_count;
    if (compress || table_size == 0) {
      for (U32 k = 0; k < symbols; ++k) {
        distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
        sum += symbol_count[k];
      }
    } else {
      for (U32 k = 0; k < symbols; ++k) {
        distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
        sum += symbol_count[k];
        const U32 w = distribution[k] >> table_shift;
        while (s < w) decoder_table[++s] = k - 1;
      }
      decoder_table[0] = 0;
      while (s <= table_size) decoder_table[++s] = symbols - 1;
    }
    update_cycle = (5 * update_cycle) >> 2;
    const U32 max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

// ------------------------------------------------------------------------ //
// Arithmetic encoder / decoder over memory buffers.

struct Encoder {
  U8* out = nullptr;
  I64 cap = 0, pos = 0;
  bool overflow = false;
  U32 base = 0, length = 0;

  void init(U8* buf, I64 buf_cap, I64 start) {
    out = buf;
    cap = buf_cap;
    pos = start;
    overflow = false;
    base = 0;
    length = AC_MAX_LENGTH;
  }
  void put_byte(U8 b) {
    if (pos < cap) out[pos] = b; else overflow = true;
    ++pos;
  }
  void propagate_carry() {
    I64 p = pos - 1;
    while (p >= 0 && p < cap && out[p] == 0xFF) out[p--] = 0;
    if (p >= 0 && p < cap) ++out[p];
  }
  void renorm() {
    do {
      put_byte((U8)(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MIN_LENGTH);
  }
  void encode_bit(BitModel& m, U32 bit) {
    const U32 x = m.bit_0_prob * (length >> BM_LENGTH_SHIFT);
    if (bit == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      const U32 init_base = base;
      base += x;
      length -= x;
      if (init_base > base) propagate_carry();
    }
    if (length < AC_MIN_LENGTH) renorm();
    if (--m.bits_until_update == 0) m.update();
  }
  void encode_symbol(SymbolModel& m, U32 sym) {
    U32 x;
    const U32 init_base = base;
    if (sym == m.last_symbol) {
      x = m.distribution[sym] * (length >> DM_LENGTH_SHIFT);
      base += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LENGTH_SHIFT);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base) propagate_carry();
    if (length < AC_MIN_LENGTH) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }
  void write_bits(U32 bits, U32 sym) {
    if (bits > 19) {
      write_bits(16, sym & 0xFFFFu);
      sym >>= 16;
      bits -= 16;
    }
    const U32 init_base = base;
    base += sym * (length >>= bits);
    if (init_base > base) propagate_carry();
    if (length < AC_MIN_LENGTH) renorm();
  }
  void done() {
    const U32 init_base = base;
    if (length > 2 * AC_MIN_LENGTH) {
      base += AC_MIN_LENGTH;
      length = AC_MIN_LENGTH >> 1;
    } else {
      base += AC_MIN_LENGTH >> 1;
      length = AC_MIN_LENGTH >> 9;
    }
    if (init_base > base) propagate_carry();
    renorm();
  }
};

struct Decoder {
  const U8* in = nullptr;
  I64 len = 0, pos = 0;
  U32 value = 0, length = 0;

  U8 get_byte() { return pos < len ? in[pos++] : 0; }
  void init(const U8* buf, I64 buf_len, I64 start) {
    in = buf;
    len = buf_len;
    pos = start;
    value = ((U32)get_byte() << 24) | ((U32)get_byte() << 16)
            | ((U32)get_byte() << 8) | get_byte();
    length = AC_MAX_LENGTH;
  }
  void renorm() {
    do {
      value = (value << 8) | get_byte();
    } while ((length <<= 8) < AC_MIN_LENGTH);
  }
  U32 decode_bit(BitModel& m) {
    const U32 x = m.bit_0_prob * (length >> BM_LENGTH_SHIFT);
    const U32 sym = (value >= x);
    if (sym == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      value -= x;
      length -= x;
    }
    if (length < AC_MIN_LENGTH) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }
  U32 decode_symbol(SymbolModel& m) {
    U32 n, sym, x, y = length;
    if (m.decoder_table) {
      const U32 dv = value / (length >>= DM_LENGTH_SHIFT);
      const U32 t = dv >> m.table_shift;
      sym = m.decoder_table[t];
      n = m.decoder_table[t + 1] + 1;
      while (n > sym + 1) {
        const U32 k = (sym + n) >> 1;
        if (m.distribution[k] > dv) n = k; else sym = k;
      }
      x = m.distribution[sym] * length;
      if (sym != m.last_symbol) y = m.distribution[sym + 1] * length;
    } else {
      x = sym = 0;
      length >>= DM_LENGTH_SHIFT;
      U32 k = (n = m.symbols) >> 1;
      do {
        const U32 z = length * m.distribution[k];
        if (z > value) {
          n = k;
          y = z;
        } else {
          sym = k;
          x = z;
        }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x;
    length = y - x;
    if (length < AC_MIN_LENGTH) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }
  U32 read_bits(U32 bits) {
    if (bits > 19) {
      const U32 lo = read_bits(16);
      const U32 hi = read_bits(bits - 16);
      return (hi << 16) | lo;
    }
    const U32 sym = value / (length >>= bits);
    value -= length * sym;
    if (length < AC_MIN_LENGTH) renorm();
    return sym;
  }
};

// ------------------------------------------------------------------------ //
// IntegerCompressor: k-bit interval corrector coding.

struct IntegerCompressor {
  U32 bits, contexts, bits_high;
  U32 corr_bits;
  U32 corr_range;
  I32 corr_min, corr_max;
  U32 k = 0;
  SymbolModel* m_bits = nullptr;      // [contexts] models of corr_bits+1 syms
  BitModel corrector0;
  SymbolModel* m_corrector = nullptr;  // [corr_bits+1], index 1..corr_bits

  IntegerCompressor(U32 bits_ = 16, U32 contexts_ = 1, U32 bits_high_ = 8)
      : bits(bits_), contexts(contexts_), bits_high(bits_high_) {
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -(I32)(corr_range / 2);
      corr_max = corr_min + (I32)corr_range - 1;
    } else {
      corr_bits = 32;
      corr_range = 0;  // wrap via natural 32-bit overflow
      corr_min = INT32_MIN;
      corr_max = INT32_MAX;
    }
  }
  ~IntegerCompressor() {
    delete[] m_bits;
    delete[] m_corrector;
  }

  void setup(bool for_compress) {
    if (!m_bits) {
      m_bits = new SymbolModel[contexts];
      for (U32 c = 0; c < contexts; ++c) m_bits[c].setup(corr_bits + 1, for_compress);
      m_corrector = new SymbolModel[corr_bits + 1];
      for (U32 j = 1; j <= corr_bits; ++j) {
        m_corrector[j].setup(j <= bits_high ? (1u << j) : (1u << bits_high),
                             for_compress);
      }
    }
    for (U32 c = 0; c < contexts; ++c) m_bits[c].init();
    corrector0.init();
    for (U32 j = 1; j <= corr_bits; ++j) m_corrector[j].init();
  }

  I32 decompress(Decoder& dec, I32 pred, U32 context) {
    I32 real = pred + read_corrector(dec, m_bits[context]);
    if (corr_range) {
      if (real < 0) real += (I32)corr_range;
      else if ((U32)real >= corr_range) real -= (I32)corr_range;
    }
    return real;
  }
  void compress(Encoder& enc, I32 pred, I32 real, U32 context) {
    I32 corr = (I32)((U32)real - (U32)pred);
    if (corr_range) {
      if (corr < corr_min) corr += (I32)corr_range;
      else if (corr > corr_max) corr -= (I32)corr_range;
    }
    write_corrector(enc, corr, m_bits[context]);
  }

  I32 read_corrector(Decoder& dec, SymbolModel& mb) {
    I32 c;
    k = dec.decode_symbol(mb);
    if (k) {
      if (k < 32) {
        if (k <= bits_high) {
          c = (I32)dec.decode_symbol(m_corrector[k]);
        } else {
          const U32 k1 = k - bits_high;
          c = (I32)dec.decode_symbol(m_corrector[k]);
          const U32 c1 = dec.read_bits(k1);
          c = (I32)(((U32)c << k1) | c1);
        }
        if (c >= (1 << (k - 1))) c += 1;
        else c -= ((1 << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = (I32)dec.decode_bit(corrector0);
    }
    return c;
  }
  void write_corrector(Encoder& enc, I32 c, SymbolModel& mb) {
    k = 0;
    U32 c1 = (c <= 0) ? (U32)(-(I64)c) : (U32)(c - 1);
    while (c1) {
      c1 >>= 1;
      ++k;
    }
    enc.encode_symbol(mb, k);
    if (k) {
      if (k < 32) {
        if (c >= 0) c -= 1;           // [2^(k-1)+1 .. 2^k]      -> [2^(k-1) .. 2^k-1]
        else c += ((1 << k) - 1);     // [-(2^k-1) .. -2^(k-1)]  -> [0 .. 2^(k-1)-1]
        if (k <= bits_high) {
          enc.encode_symbol(m_corrector[k], (U32)c);
        } else {
          const U32 k1 = k - bits_high;
          enc.encode_symbol(m_corrector[k], (U32)c >> k1);
          enc.write_bits(k1, (U32)c & ((1u << k1) - 1));
        }
      }
    } else {
      enc.encode_bit(corrector0, (U32)c);
    }
  }
};

// ------------------------------------------------------------------------ //
// POINT10 v2.

struct StreamingMedian5 {
  I32 values[5];
  bool high;
  void init() {
    values[0] = values[1] = values[2] = values[3] = values[4] = 0;
    high = true;
  }
  void add(I32 v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3];
        values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1];
          values[1] = values[0];
          values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1];
          values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) {
          values[4] = values[3];
          values[3] = v;
        } else {
          values[4] = v;
        }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1];
        values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3];
          values[3] = values[4];
          values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3];
          values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) {
          values[0] = values[1];
          values[1] = v;
        } else {
          values[0] = v;
        }
        high = true;
      }
    }
  }
  I32 get() const { return values[2]; }
};

const U8 kNumberReturnMap[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8},  {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},    {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},    {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};
const U8 kNumberReturnLevel[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

inline U8 u8_fold(I32 n) { return (U8)(n & 0xFF); }
inline U8 u8_clamp(I32 n) { return n <= 0 ? 0 : (n >= 255 ? 255 : (U8)n); }

// The raw 20-byte POINT10 record (little-endian field layout of LAS
// point data record format 0).
struct Point10 {
  I32 x, y, z;
  U16 intensity;
  U8 bit_byte;  // return#:3 | #returns:3 | scan dir:1 | edge:1
  U8 classification;
  I8 scan_angle_rank;
  U8 user_data;
  U16 point_source_id;

  void load(const U8* p) {
    std::memcpy(&x, p, 4);
    std::memcpy(&y, p + 4, 4);
    std::memcpy(&z, p + 8, 4);
    std::memcpy(&intensity, p + 12, 2);
    bit_byte = p[14];
    classification = p[15];
    scan_angle_rank = (I8)p[16];
    user_data = p[17];
    std::memcpy(&point_source_id, p + 18, 2);
  }
  void store(U8* p) const {
    std::memcpy(p, &x, 4);
    std::memcpy(p + 4, &y, 4);
    std::memcpy(p + 8, &z, 4);
    std::memcpy(p + 12, &intensity, 2);
    p[14] = bit_byte;
    p[15] = classification;
    p[16] = (U8)scan_angle_rank;
    p[17] = user_data;
    std::memcpy(p + 18, &point_source_id, 2);
  }
  U8 return_number() const { return bit_byte & 7; }
  U8 number_of_returns() const { return (bit_byte >> 3) & 7; }
  U8 scan_direction_flag() const { return (bit_byte >> 6) & 1; }
};

struct Point10v2 {
  SymbolModel m_changed_values;
  IntegerCompressor ic_intensity{16, 4};
  SymbolModel m_scan_angle_rank[2];
  IntegerCompressor ic_point_source_id{16, 1};
  SymbolModel* m_bit_byte[256] = {};
  SymbolModel* m_classification[256] = {};
  SymbolModel* m_user_data[256] = {};
  IntegerCompressor ic_dx{32, 2};
  IntegerCompressor ic_dy{32, 22};
  IntegerCompressor ic_z{32, 20};
  StreamingMedian5 last_x_diff_median5[16];
  StreamingMedian5 last_y_diff_median5[16];
  U16 last_intensity[16];
  I32 last_height[8];
  Point10 last;
  bool for_compress = false;
  bool allocated = false;

  ~Point10v2() {
    for (int i = 0; i < 256; ++i) {
      delete m_bit_byte[i];
      delete m_classification[i];
      delete m_user_data[i];
    }
  }

  void init(const U8* first_item, bool compress_mode) {
    if (!allocated || for_compress != compress_mode) {
      for (int i = 0; i < 256; ++i) {
        delete m_bit_byte[i];
        m_bit_byte[i] = nullptr;
        delete m_classification[i];
        m_classification[i] = nullptr;
        delete m_user_data[i];
        m_user_data[i] = nullptr;
      }
      m_changed_values.setup(64, compress_mode);
      m_scan_angle_rank[0].setup(256, compress_mode);
      m_scan_angle_rank[1].setup(256, compress_mode);
      allocated = true;
      for_compress = compress_mode;
    } else {
      // Lazily-created per-value models must reset between chunks too.
      for (int i = 0; i < 256; ++i) {
        if (m_bit_byte[i]) m_bit_byte[i]->init();
        if (m_classification[i]) m_classification[i]->init();
        if (m_user_data[i]) m_user_data[i]->init();
      }
    }
    m_changed_values.init();
    ic_intensity.setup(compress_mode);
    m_scan_angle_rank[0].init();
    m_scan_angle_rank[1].init();
    ic_point_source_id.setup(compress_mode);
    ic_dx.setup(compress_mode);
    ic_dy.setup(compress_mode);
    ic_z.setup(compress_mode);
    for (int i = 0; i < 16; ++i) {
      last_x_diff_median5[i].init();
      last_y_diff_median5[i].init();
      last_intensity[i] = 0;
    }
    for (int i = 0; i < 8; ++i) last_height[i] = 0;
    last.load(first_item);
  }

  SymbolModel* lazy(SymbolModel** arr, U8 idx) {
    if (!arr[idx]) {
      arr[idx] = new SymbolModel();
      arr[idx]->setup(256, for_compress);
      arr[idx]->init();
    }
    return arr[idx];
  }

  void read(Decoder& dec, U8* item) {
    const U32 changed_values = dec.decode_symbol(m_changed_values);
    if (changed_values) {
      if (changed_values & 32) {
        last.bit_byte = (U8)dec.decode_symbol(*lazy(m_bit_byte, last.bit_byte));
      }
      const U32 r = last.return_number(), n = last.number_of_returns();
      const U32 m = kNumberReturnMap[n][r];
      if (changed_values & 16) {
        last_intensity[m] = (U16)ic_intensity.decompress(
            dec, last_intensity[m], m < 3 ? m : 3u);
      }
      last.intensity = last_intensity[m];
      if (changed_values & 8) {
        last.classification =
            (U8)dec.decode_symbol(*lazy(m_classification, last.classification));
      }
      if (changed_values & 4) {
        const U32 val = dec.decode_symbol(m_scan_angle_rank[last.scan_direction_flag()]);
        last.scan_angle_rank = (I8)u8_fold((I32)val + (I32)(U8)last.scan_angle_rank);
      }
      if (changed_values & 2) {
        last.user_data = (U8)dec.decode_symbol(*lazy(m_user_data, last.user_data));
      }
      if (changed_values & 1) {
        last.point_source_id =
            (U16)ic_point_source_id.decompress(dec, last.point_source_id, 0);
      }
    } else {
      last.intensity = last_intensity[kNumberReturnMap[last.number_of_returns()][last.return_number()]];
    }
    const U32 r = last.return_number(), n = last.number_of_returns();
    const U32 m = kNumberReturnMap[n][r];
    const U32 l = kNumberReturnLevel[n][r];

    I32 median = last_x_diff_median5[m].get();
    I32 diff = ic_dx.decompress(dec, median, n == 1);
    last.x += diff;
    last_x_diff_median5[m].add(diff);

    median = last_y_diff_median5[m].get();
    U32 k_bits = ic_dx.k;
    diff = ic_dy.decompress(dec, median,
                            (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    last.y += diff;
    last_y_diff_median5[m].add(diff);

    k_bits = (ic_dx.k + ic_dy.k) / 2;
    last.z = ic_z.decompress(dec, last_height[l],
                             (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    last_height[l] = last.z;
    last.store(item);
  }

  void write(Encoder& enc, const U8* item) {
    Point10 cur;
    cur.load(item);
    const U32 r = cur.return_number(), n = cur.number_of_returns();
    const U32 m = kNumberReturnMap[n][r];
    const U32 l = kNumberReturnLevel[n][r];

    const U32 changed_values =
        (((U32)(last.bit_byte != cur.bit_byte)) << 5) |
        (((U32)(last_intensity[m] != cur.intensity)) << 4) |
        (((U32)(last.classification != cur.classification)) << 3) |
        (((U32)(last.scan_angle_rank != cur.scan_angle_rank)) << 2) |
        (((U32)(last.user_data != cur.user_data)) << 1) |
        ((U32)(last.point_source_id != cur.point_source_id));
    enc.encode_symbol(m_changed_values, changed_values);
    if (changed_values) {
      if (changed_values & 32) {
        enc.encode_symbol(*lazy(m_bit_byte, last.bit_byte), cur.bit_byte);
      }
      if (changed_values & 16) {
        ic_intensity.compress(enc, last_intensity[m], cur.intensity,
                              m < 3 ? m : 3u);
        last_intensity[m] = cur.intensity;
      }
      if (changed_values & 8) {
        enc.encode_symbol(*lazy(m_classification, last.classification),
                          cur.classification);
      }
      if (changed_values & 4) {
        // Context from the NEW bit byte (mirrors read, which decodes the
        // bit byte before the scan angle).
        enc.encode_symbol(m_scan_angle_rank[cur.scan_direction_flag()],
                          u8_fold((I32)(U8)cur.scan_angle_rank -
                                  (I32)(U8)last.scan_angle_rank));
      }
      if (changed_values & 2) {
        enc.encode_symbol(*lazy(m_user_data, last.user_data), cur.user_data);
      }
      if (changed_values & 1) {
        ic_point_source_id.compress(enc, last.point_source_id,
                                    cur.point_source_id, 0);
      }
    }

    I32 median = last_x_diff_median5[m].get();
    I32 diff = cur.x - last.x;
    ic_dx.compress(enc, median, diff, n == 1);
    last_x_diff_median5[m].add(diff);

    median = last_y_diff_median5[m].get();
    U32 k_bits = ic_dx.k;
    diff = cur.y - last.y;
    ic_dy.compress(enc, median, diff,
                   (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    last_y_diff_median5[m].add(diff);

    k_bits = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], cur.z,
                  (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    last_height[l] = cur.z;
    last = cur;
  }
};

// ------------------------------------------------------------------------ //
// GPSTIME11 v2.

constexpr I32 kGpsMulti = 500;
constexpr I32 kGpsMultiMinus = -10;
constexpr I32 kGpsMultiUnchanged = kGpsMulti - kGpsMultiMinus + 1;   // 511
constexpr I32 kGpsMultiCodeFull = kGpsMulti - kGpsMultiMinus + 2;    // 512
constexpr I32 kGpsMultiTotal = kGpsMulti - kGpsMultiMinus + 6;       // 516

inline I32 i32_quantize(double f) {
  if (f >= 2147483647.0) return INT32_MAX;
  if (f <= -2147483648.0) return INT32_MIN;
  return f >= 0 ? (I32)(f + 0.5) : (I32)(f - 0.5);
}

// Wrapping i32 multiply (the 32-bit corrector wraps mod 2^32, so prediction
// overflow must wrap identically on both codec sides; signed overflow is UB).
inline I32 mul_wrap(I32 a, I32 b) { return (I32)((U32)a * (U32)b); }

struct GpsTime11v2 {
  SymbolModel m_gpstime_multi;
  SymbolModel m_gpstime_0diff;
  IntegerCompressor ic_gpstime{32, 9};
  U32 last_seq = 0, next_seq = 0;
  I64 last_gpstime[4];
  I32 last_gpstime_diff[4];
  I32 multi_extreme_counter[4];
  bool allocated = false;

  void init(const U8* first_item, bool compress_mode) {
    if (!allocated) {
      m_gpstime_multi.setup(kGpsMultiTotal, compress_mode);
      m_gpstime_0diff.setup(6, compress_mode);
      allocated = true;
    }
    m_gpstime_multi.init();
    m_gpstime_0diff.init();
    ic_gpstime.setup(compress_mode);
    last_seq = next_seq = 0;
    for (int i = 0; i < 4; ++i) {
      last_gpstime[i] = 0;
      last_gpstime_diff[i] = 0;
      multi_extreme_counter[i] = 0;
    }
    std::memcpy(&last_gpstime[0], first_item, 8);
  }

  void read(Decoder& dec, U8* item) {
    if (last_gpstime_diff[last_seq] == 0) {
      const U32 multi = dec.decode_symbol(m_gpstime_0diff);
      if (multi == 1) {  // difference fits in 32 bits
        last_gpstime_diff[last_seq] = ic_gpstime.decompress(dec, 0, 0);
        last_gpstime[last_seq] += last_gpstime_diff[last_seq];
        multi_extreme_counter[last_seq] = 0;
      } else if (multi == 2) {  // full 64-bit value
        next_seq = (next_seq + 1) & 3;
        U64 hi = (U64)(U32)ic_gpstime.decompress(
            dec, (I32)(U32)((U64)last_gpstime[last_seq] >> 32), 8);
        U64 v = (hi << 32) | dec.read_bits(32);
        last_gpstime[next_seq] = (I64)v;
        last_seq = next_seq;
        last_gpstime_diff[last_seq] = 0;
        multi_extreme_counter[last_seq] = 0;
      } else if (multi > 2) {  // switch to another sequence
        last_seq = (last_seq + multi - 2) & 3;
        read(dec, item);
        return;
      }
      // multi == 0: unchanged
    } else {
      const I32 multi = (I32)dec.decode_symbol(m_gpstime_multi);
      if (multi == 1) {
        last_gpstime[last_seq] +=
            ic_gpstime.decompress(dec, last_gpstime_diff[last_seq], 1);
        multi_extreme_counter[last_seq] = 0;
      } else if (multi < kGpsMultiUnchanged) {
        I32 gpstime_diff;
        if (multi == 0) {
          gpstime_diff = ic_gpstime.decompress(dec, 0, 7);
          if (++multi_extreme_counter[last_seq] > 3) {
            last_gpstime_diff[last_seq] = gpstime_diff;
            multi_extreme_counter[last_seq] = 0;
          }
        } else if (multi < kGpsMulti) {
          gpstime_diff = ic_gpstime.decompress(
              dec, mul_wrap(multi, last_gpstime_diff[last_seq]), multi < 10 ? 2u : 3u);
        } else if (multi == kGpsMulti) {
          gpstime_diff = ic_gpstime.decompress(
              dec, mul_wrap(kGpsMulti, last_gpstime_diff[last_seq]), 4);
          if (++multi_extreme_counter[last_seq] > 3) {
            last_gpstime_diff[last_seq] = gpstime_diff;
            multi_extreme_counter[last_seq] = 0;
          }
        } else {  // 501..510: negative multipliers
          const I32 neg = kGpsMulti - multi;  // -1..-10
          if (neg > kGpsMultiMinus) {
            gpstime_diff = ic_gpstime.decompress(
                dec, mul_wrap(neg, last_gpstime_diff[last_seq]), 5);
          } else {
            gpstime_diff = ic_gpstime.decompress(
                dec, mul_wrap(kGpsMultiMinus, last_gpstime_diff[last_seq]), 6);
            if (++multi_extreme_counter[last_seq] > 3) {
              last_gpstime_diff[last_seq] = gpstime_diff;
              multi_extreme_counter[last_seq] = 0;
            }
          }
        }
        last_gpstime[last_seq] += gpstime_diff;
      } else if (multi == kGpsMultiUnchanged) {
        // no change
      } else if (multi == kGpsMultiCodeFull) {
        next_seq = (next_seq + 1) & 3;
        U64 hi = (U64)(U32)ic_gpstime.decompress(
            dec, (I32)(U32)((U64)last_gpstime[last_seq] >> 32), 8);
        U64 v = (hi << 32) | dec.read_bits(32);
        last_gpstime[next_seq] = (I64)v;
        last_seq = next_seq;
        last_gpstime_diff[last_seq] = 0;
        multi_extreme_counter[last_seq] = 0;
      } else {  // 513..515: switch sequence
        last_seq = (last_seq + multi - kGpsMultiCodeFull) & 3;
        read(dec, item);
        return;
      }
    }
    std::memcpy(item, &last_gpstime[last_seq], 8);
  }

  void write(Encoder& enc, const U8* item) {
    I64 cur;
    std::memcpy(&cur, item, 8);
    if (last_gpstime_diff[last_seq] == 0) {
      if (cur == last_gpstime[last_seq]) {
        enc.encode_symbol(m_gpstime_0diff, 0);
        return;
      }
      const I64 diff64 = cur - last_gpstime[last_seq];
      const I32 diff32 = (I32)diff64;
      if (diff64 == (I64)diff32) {
        enc.encode_symbol(m_gpstime_0diff, 1);
        ic_gpstime.compress(enc, 0, diff32, 0);
        last_gpstime_diff[last_seq] = diff32;
        last_gpstime[last_seq] = cur;
        multi_extreme_counter[last_seq] = 0;
        return;
      }
      // Try switching to a sequence whose value matches better.
      for (U32 i = 1; i < 4; ++i) {
        const I64 od = cur - last_gpstime[(last_seq + i) & 3];
        if (od == (I64)(I32)od || last_gpstime[(last_seq + i) & 3] == cur) {
          enc.encode_symbol(m_gpstime_0diff, i + 2);
          last_seq = (last_seq + i) & 3;
          write(enc, item);
          return;
        }
      }
      enc.encode_symbol(m_gpstime_0diff, 2);
      write_full(enc, cur);
    } else {
      if (cur == last_gpstime[last_seq]) {
        enc.encode_symbol(m_gpstime_multi, kGpsMultiUnchanged);
        return;
      }
      const I64 diff64 = cur - last_gpstime[last_seq];
      const I32 diff32 = (I32)diff64;
      if (diff64 == (I64)diff32) {
        const I32 multi =
            i32_quantize((double)diff32 / (double)last_gpstime_diff[last_seq]);
        if (multi == 1) {
          enc.encode_symbol(m_gpstime_multi, 1);
          ic_gpstime.compress(enc, last_gpstime_diff[last_seq], diff32, 1);
          multi_extreme_counter[last_seq] = 0;
        } else if (multi > 1) {
          if (multi < kGpsMulti) {
            enc.encode_symbol(m_gpstime_multi, (U32)multi);
            ic_gpstime.compress(enc, mul_wrap(multi, last_gpstime_diff[last_seq]),
                                diff32, multi < 10 ? 2u : 3u);
          } else {
            enc.encode_symbol(m_gpstime_multi, (U32)kGpsMulti);
            ic_gpstime.compress(enc, mul_wrap(kGpsMulti, last_gpstime_diff[last_seq]),
                                diff32, 4);
            if (++multi_extreme_counter[last_seq] > 3) {
              last_gpstime_diff[last_seq] = diff32;
              multi_extreme_counter[last_seq] = 0;
            }
          }
        } else if (multi < 0) {
          if (multi > kGpsMultiMinus) {  // -1..-9
            enc.encode_symbol(m_gpstime_multi, (U32)(kGpsMulti - multi));
            ic_gpstime.compress(enc, mul_wrap(multi, last_gpstime_diff[last_seq]),
                                diff32, 5);
          } else {
            enc.encode_symbol(m_gpstime_multi,
                              (U32)(kGpsMulti - kGpsMultiMinus));
            ic_gpstime.compress(enc,
                                mul_wrap(kGpsMultiMinus, last_gpstime_diff[last_seq]),
                                diff32, 6);
            if (++multi_extreme_counter[last_seq] > 3) {
              last_gpstime_diff[last_seq] = diff32;
              multi_extreme_counter[last_seq] = 0;
            }
          }
        } else {  // multi == 0
          enc.encode_symbol(m_gpstime_multi, 0);
          ic_gpstime.compress(enc, 0, diff32, 7);
          if (++multi_extreme_counter[last_seq] > 3) {
            last_gpstime_diff[last_seq] = diff32;
            multi_extreme_counter[last_seq] = 0;
          }
        }
        last_gpstime[last_seq] = cur;
      } else {
        for (U32 i = 1; i < 4; ++i) {
          const I64 od = cur - last_gpstime[(last_seq + i) & 3];
          if (od == (I64)(I32)od) {
            enc.encode_symbol(m_gpstime_multi,
                              (U32)(kGpsMultiCodeFull + i));
            last_seq = (last_seq + i) & 3;
            write(enc, item);
            return;
          }
        }
        enc.encode_symbol(m_gpstime_multi, (U32)kGpsMultiCodeFull);
        write_full(enc, cur);
      }
    }
  }

  void write_full(Encoder& enc, I64 cur) {
    next_seq = (next_seq + 1) & 3;
    ic_gpstime.compress(enc, (I32)(U32)((U64)last_gpstime[last_seq] >> 32),
                        (I32)(U32)((U64)cur >> 32), 8);
    enc.write_bits(32, (U32)(U64)cur);
    last_gpstime[next_seq] = cur;
    last_seq = next_seq;
    last_gpstime_diff[last_seq] = 0;
    multi_extreme_counter[last_seq] = 0;
  }
};

// ------------------------------------------------------------------------ //
// RGB12 v2.

struct Rgb12v2 {
  SymbolModel m_byte_used;
  SymbolModel m_rgb_diff[6];
  U16 last_r = 0, last_g = 0, last_b = 0;
  bool allocated = false;

  void init(const U8* first_item, bool compress_mode) {
    if (!allocated) {
      m_byte_used.setup(128, compress_mode);
      for (int i = 0; i < 6; ++i) m_rgb_diff[i].setup(256, compress_mode);
      allocated = true;
    }
    m_byte_used.init();
    for (int i = 0; i < 6; ++i) m_rgb_diff[i].init();
    std::memcpy(&last_r, first_item, 2);
    std::memcpy(&last_g, first_item + 2, 2);
    std::memcpy(&last_b, first_item + 4, 2);
  }

  void read(Decoder& dec, U8* item) {
    U8 corr;
    I32 diff = 0;
    const U32 sym = dec.decode_symbol(m_byte_used);
    U16 r, g, b;
    if (sym & 1) {
      corr = (U8)dec.decode_symbol(m_rgb_diff[0]);
      r = (U16)u8_fold(corr + (last_r & 0xFF));
    } else {
      r = last_r & 0xFF;
    }
    if (sym & 2) {
      corr = (U8)dec.decode_symbol(m_rgb_diff[1]);
      r |= ((U16)u8_fold(corr + (last_r >> 8))) << 8;
    } else {
      r |= last_r & 0xFF00;
    }
    if (sym & 64) {
      diff = (r & 0xFF) - (last_r & 0xFF);
      if (sym & 4) {
        corr = (U8)dec.decode_symbol(m_rgb_diff[2]);
        g = (U16)u8_fold(corr + u8_clamp(diff + (last_g & 0xFF)));
      } else {
        g = last_g & 0xFF;
      }
      if (sym & 16) {
        corr = (U8)dec.decode_symbol(m_rgb_diff[4]);
        diff = (diff + ((g & 0xFF) - (last_g & 0xFF))) / 2;
        b = (U16)u8_fold(corr + u8_clamp(diff + (last_b & 0xFF)));
      } else {
        b = last_b & 0xFF;
      }
      diff = (r >> 8) - (last_r >> 8);
      if (sym & 8) {
        corr = (U8)dec.decode_symbol(m_rgb_diff[3]);
        g |= ((U16)u8_fold(corr + u8_clamp(diff + (last_g >> 8)))) << 8;
      } else {
        g |= last_g & 0xFF00;
      }
      if (sym & 32) {
        corr = (U8)dec.decode_symbol(m_rgb_diff[5]);
        diff = (diff + ((g >> 8) - (last_g >> 8))) / 2;
        b |= ((U16)u8_fold(corr + u8_clamp(diff + (last_b >> 8)))) << 8;
      } else {
        b |= last_b & 0xFF00;
      }
    } else {
      g = r;
      b = r;
    }
    last_r = r;
    last_g = g;
    last_b = b;
    std::memcpy(item, &r, 2);
    std::memcpy(item + 2, &g, 2);
    std::memcpy(item + 4, &b, 2);
  }

  void write(Encoder& enc, const U8* item) {
    U16 r, g, b;
    std::memcpy(&r, item, 2);
    std::memcpy(&g, item + 2, 2);
    std::memcpy(&b, item + 4, 2);
    U32 sym = ((last_r & 0xFF) != (r & 0xFF)) ? 1u : 0u;
    if ((last_r >> 8) != (r >> 8)) sym |= 2;
    const bool grey = (r == g) && (r == b) && ((sym & 3) != 0 || (last_g == last_r && last_b == last_r));
    // "g/b differ from r" bit: set unless this point is grey AND the
    // predictor degenerates to r for both (mirror of the read path's
    // sym&64 branch).
    bool need_gb = !(r == g && r == b);
    if (need_gb) sym |= 64;
    (void)grey;
    I32 diff;
    if (sym & 64) {
      if ((last_g & 0xFF) != (g & 0xFF)) sym |= 4;
      if ((last_g >> 8) != (g >> 8)) sym |= 8;
      if ((last_b & 0xFF) != (b & 0xFF)) sym |= 16;
      if ((last_b >> 8) != (b >> 8)) sym |= 32;
      // The low/high G/B bytes are coded as corrections against CLAMPED
      // predictions; a clear bit means "equal to last", which the read
      // path honours independent of the prediction, so the bit flags
      // computed from plain equality are consistent.
    }
    enc.encode_symbol(m_byte_used, sym);
    if (sym & 1) {
      enc.encode_symbol(m_rgb_diff[0], u8_fold((I32)(r & 0xFF) - (I32)(last_r & 0xFF)));
    }
    if (sym & 2) {
      enc.encode_symbol(m_rgb_diff[1], u8_fold((I32)(r >> 8) - (I32)(last_r >> 8)));
    }
    if (sym & 64) {
      diff = (r & 0xFF) - (last_r & 0xFF);
      if (sym & 4) {
        enc.encode_symbol(m_rgb_diff[2],
                          u8_fold((I32)(g & 0xFF) - u8_clamp(diff + (last_g & 0xFF))));
      }
      if (sym & 16) {
        diff = (diff + ((g & 0xFF) - (last_g & 0xFF))) / 2;
        enc.encode_symbol(m_rgb_diff[4],
                          u8_fold((I32)(b & 0xFF) - u8_clamp(diff + (last_b & 0xFF))));
      }
      diff = (r >> 8) - (last_r >> 8);
      if (sym & 8) {
        enc.encode_symbol(m_rgb_diff[3],
                          u8_fold((I32)(g >> 8) - u8_clamp(diff + (last_g >> 8))));
      }
      if (sym & 32) {
        diff = (diff + ((g >> 8) - (last_g >> 8))) / 2;
        enc.encode_symbol(m_rgb_diff[5],
                          u8_fold((I32)(b >> 8) - u8_clamp(diff + (last_b >> 8))));
      }
    }
    last_r = r;
    last_g = g;
    last_b = b;
  }
};

// ------------------------------------------------------------------------ //
// BYTE v2 (extra bytes): per-byte delta symbol models.

struct Byte_v2 {
  SymbolModel* m_byte = nullptr;
  U8* last = nullptr;
  U32 count = 0;
  bool allocated = false;

  ~Byte_v2() {
    delete[] m_byte;
    delete[] last;
  }

  void init(const U8* first_item, U32 n, bool compress_mode) {
    if (!allocated || count != n) {
      delete[] m_byte;
      delete[] last;
      count = n;
      m_byte = new SymbolModel[n];
      for (U32 i = 0; i < n; ++i) m_byte[i].setup(256, compress_mode);
      last = new U8[n];
      allocated = true;
    }
    for (U32 i = 0; i < n; ++i) m_byte[i].init();
    std::memcpy(last, first_item, n);
  }

  void read(Decoder& dec, U8* item) {
    for (U32 i = 0; i < count; ++i) {
      last[i] = u8_fold((I32)dec.decode_symbol(m_byte[i]) + last[i]);
      item[i] = last[i];
    }
  }
  void write(Encoder& enc, const U8* item) {
    for (U32 i = 0; i < count; ++i) {
      enc.encode_symbol(m_byte[i], u8_fold((I32)item[i] - (I32)last[i]));
      last[i] = item[i];
    }
  }
};

// ------------------------------------------------------------------------ //
// LAS 1.4 layered codecs (LASzip "native extension", compressor 3) for
// point formats 6-10: POINT14 / RGB14 / RGBNIR14 / BYTE14.
//
// Container framing follows the native extension: per chunk the stream is
// [raw first point (all items, item order)] [u32 byte count per layer, in
// item/layer order] [layer payloads in the same order]; the chunk table is
// the compressor-2 one.  Model structure follows the v3 design: FOUR
// scanner-channel contexts each holding complete model state (switched via
// the changed-values symbol, fresh contexts initialised from the previous
// context's last point), nine POINT14 layers (channel_returns_XY, Z,
// classification, flags, intensity, scan_angle, user_data, point_source,
// gpstime), per-layer independent arithmetic streams enabling selective
// decompression.  The per-field entropy models reuse this library's
// spec-verified v2 primitives (FastAC models, IntegerCompressor, streaming
// medians, multi-sequence GPS prediction).  Round-trips are pinned by
// tests/test_laz.py; cross-implementation bit-compatibility for formats 6+
// could NOT be verified in this environment (no third-party .laz or laszip
// build available) and is not claimed — docs/STATUS.md carries the caveat.

// Raw 30-byte POINT14 record (LAS 1.4 point data record format 6).
struct Point14 {
  I32 x, y, z;
  U16 intensity;
  U8 returns_byte;  // return#:4 | #returns:4
  U8 flags_byte;    // class flags:4 | scanner channel:2 | scan dir:1 | edge:1
  U8 classification;
  U8 user_data;
  I16 scan_angle;
  U16 point_source_id;
  U8 gps[8];

  void load(const U8* p) {
    std::memcpy(&x, p, 4);
    std::memcpy(&y, p + 4, 4);
    std::memcpy(&z, p + 8, 4);
    std::memcpy(&intensity, p + 12, 2);
    returns_byte = p[14];
    flags_byte = p[15];
    classification = p[16];
    user_data = p[17];
    std::memcpy(&scan_angle, p + 18, 2);
    std::memcpy(&point_source_id, p + 20, 2);
    std::memcpy(gps, p + 22, 8);
  }
  void store(U8* p) const {
    std::memcpy(p, &x, 4);
    std::memcpy(p + 4, &y, 4);
    std::memcpy(p + 8, &z, 4);
    std::memcpy(p + 12, &intensity, 2);
    p[14] = returns_byte;
    p[15] = flags_byte;
    p[16] = classification;
    p[17] = user_data;
    std::memcpy(p + 18, &scan_angle, 2);
    std::memcpy(p + 20, &point_source_id, 2);
    std::memcpy(p + 22, gps, 8);
  }
  U8 rn() const { return returns_byte & 15; }
  U8 nr() const { return (returns_byte >> 4) & 15; }
  U8 channel() const { return (flags_byte >> 4) & 3; }
  // 6-bit flags without the scanner channel (coded via changed-values).
  U8 flags6() const { return (flags_byte & 0x0F) | (((flags_byte >> 6) & 3) << 4); }
  void set_flags6_channel(U8 f6, U8 ch) {
    flags_byte = (U8)((f6 & 0x0F) | ((ch & 3) << 4) | (((f6 >> 4) & 3) << 6));
  }
};

// POINT14 layer indices.
enum {
  kLxy = 0, kLz, kLclass, kLflags, kLint, kLscan, kLuser, kLps, kLgps,
  kPoint14Layers
};

struct Point14Ctx {
  SymbolModel m_changed[8];      // 128-symbol changed-values, lpr context
  SymbolModel m_channel;         // 3 symbols: channel delta - 1
  SymbolModel m_nr[16];          // number of returns, prev-value context
  SymbolModel m_rn[16];          // return number (gps changed), prev-value ctx
  SymbolModel m_rn_gps_same;     // 13 symbols: rn jump - 2 (gps unchanged)
  IntegerCompressor ic_dx{32, 2};
  IntegerCompressor ic_dy{32, 22};
  IntegerCompressor ic_z{32, 20};
  StreamingMedian5 med_x[16], med_y[16];
  I32 last_height[8];
  IntegerCompressor ic_intensity{16, 4};
  U16 last_intensity[16];
  SymbolModel* m_class[256] = {};
  SymbolModel* m_flags[64] = {};
  SymbolModel* m_user[256] = {};
  IntegerCompressor ic_scan_angle{16, 2};
  IntegerCompressor ic_ps{16, 1};
  GpsTime11v2 gps;
  Point14 last;
  bool last_gps_changed = false;
  bool used = false;
  bool allocated = false;
  bool for_compress = false;

  ~Point14Ctx() {
    for (int i = 0; i < 256; ++i) {
      delete m_class[i];
      delete m_user[i];
    }
    for (int i = 0; i < 64; ++i) delete m_flags[i];
  }

  SymbolModel* lazy(SymbolModel** arr, U32 idx, U32 syms) {
    if (!arr[idx]) {
      arr[idx] = new SymbolModel();
      arr[idx]->setup(syms, for_compress);
      arr[idx]->init();
    }
    return arr[idx];
  }

  void init_from(const Point14& p, bool compress_mode) {
    if (!allocated || for_compress != compress_mode) {
      for (int i = 0; i < 256; ++i) {
        delete m_class[i]; m_class[i] = nullptr;
        delete m_user[i]; m_user[i] = nullptr;
      }
      for (int i = 0; i < 64; ++i) { delete m_flags[i]; m_flags[i] = nullptr; }
      for (int i = 0; i < 8; ++i) m_changed[i].setup(128, compress_mode);
      m_channel.setup(3, compress_mode);
      for (int i = 0; i < 16; ++i) {
        m_nr[i].setup(16, compress_mode);
        m_rn[i].setup(16, compress_mode);
      }
      m_rn_gps_same.setup(13, compress_mode);
      allocated = true;
      for_compress = compress_mode;
    } else {
      for (int i = 0; i < 256; ++i) {
        if (m_class[i]) m_class[i]->init();
        if (m_user[i]) m_user[i]->init();
      }
      for (int i = 0; i < 64; ++i) if (m_flags[i]) m_flags[i]->init();
    }
    for (int i = 0; i < 8; ++i) m_changed[i].init();
    m_channel.init();
    for (int i = 0; i < 16; ++i) {
      m_nr[i].init();
      m_rn[i].init();
    }
    m_rn_gps_same.init();
    ic_dx.setup(compress_mode);
    ic_dy.setup(compress_mode);
    ic_z.setup(compress_mode);
    ic_intensity.setup(compress_mode);
    ic_scan_angle.setup(compress_mode);
    ic_ps.setup(compress_mode);
    for (int i = 0; i < 16; ++i) {
      med_x[i].init();
      med_y[i].init();
      last_intensity[i] = 0;
    }
    for (int i = 0; i < 8; ++i) last_height[i] = 0;
    gps.init(p.gps, compress_mode);
    last = p;
    last_gps_changed = false;
    used = true;
  }
};

struct Point14v3 {
  Point14Ctx ctx[4];
  U32 current = 0;
  bool compress_mode = false;

  void init(const U8* first_item, bool cm) {
    compress_mode = cm;
    Point14 p;
    p.load(first_item);
    for (int c = 0; c < 4; ++c) ctx[c].used = false;
    current = p.channel();
    ctx[current].init_from(p, cm);
  }

  // Shared per-point XYZ / field coding given the resolved rn/nr.
  static U32 clip7(U32 v) { return v < 7 ? v : 7; }

  void read(Decoder* d, U8* item) {
    Point14Ctx* c = &ctx[current];
    const U32 lpr = (U32)(c->last.rn() == 1) | ((U32)(c->last.rn() >= c->last.nr()) << 1)
                    | ((U32)c->last_gps_changed << 2);
    const U32 cv = d[kLxy].decode_symbol(c->m_changed[lpr]);
    if (cv & 64) {
      const U32 sym = d[kLxy].decode_symbol(c->m_channel);
      const U32 nc = (current + sym + 1) & 3;
      if (!ctx[nc].used) ctx[nc].init_from(c->last, compress_mode);
      current = nc;
      c = &ctx[current];
    }
    Point14 cur = c->last;
    U32 nr = c->last.nr();
    if (cv & 4) nr = d[kLxy].decode_symbol(c->m_nr[c->last.nr()]);
    U32 rn;
    switch (cv & 3) {
      case 0: rn = c->last.rn(); break;
      case 1: rn = (c->last.rn() + 1) & 15; break;
      case 2: rn = (c->last.rn() + 15) & 15; break;
      default:
        rn = (cv & 16) ? d[kLxy].decode_symbol(c->m_rn[c->last.rn()])
                       : ((c->last.rn() + 2 +
                           d[kLxy].decode_symbol(c->m_rn_gps_same)) & 15);
        break;
    }
    cur.returns_byte = (U8)(rn | (nr << 4));
    const U32 m = kNumberReturnMap[clip7(nr)][clip7(rn)];
    const U32 l = kNumberReturnLevel[clip7(nr)][clip7(rn)];

    I32 median = c->med_x[m].get();
    I32 diff = c->ic_dx.decompress(d[kLxy], median, nr == 1);
    cur.x = c->last.x + diff;
    c->med_x[m].add(diff);
    median = c->med_y[m].get();
    U32 k_bits = c->ic_dx.k;
    diff = c->ic_dy.decompress(d[kLxy], median,
                               (nr == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    cur.y = c->last.y + diff;
    c->med_y[m].add(diff);
    k_bits = (c->ic_dx.k + c->ic_dy.k) / 2;
    cur.z = c->ic_z.decompress(d[kLz], c->last_height[l],
                               (nr == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    c->last_height[l] = cur.z;

    cur.classification =
        (U8)d[kLclass].decode_symbol(*c->lazy(c->m_class, c->last.classification, 256));
    const U8 f6 =
        (U8)d[kLflags].decode_symbol(*c->lazy(c->m_flags, c->last.flags6(), 64));
    cur.set_flags6_channel(f6, (U8)current);
    c->last_intensity[m] = (U16)c->ic_intensity.decompress(
        d[kLint], c->last_intensity[m], m < 3 ? m : 3u);
    cur.intensity = c->last_intensity[m];
    if (cv & 8) {
      cur.scan_angle = (I16)c->ic_scan_angle.decompress(
          d[kLscan], c->last.scan_angle, (f6 >> 4) & 1);
    }
    cur.user_data =
        (U8)d[kLuser].decode_symbol(*c->lazy(c->m_user, c->last.user_data, 256));
    if (cv & 32) {
      cur.point_source_id = (U16)c->ic_ps.decompress(
          d[kLps], c->last.point_source_id, 0);
    }
    if (cv & 16) {
      c->gps.read(d[kLgps], cur.gps);
    }
    c->last_gps_changed = (cv & 16) != 0;
    c->last = cur;
    cur.store(item);
  }

  void write(Encoder* e, const U8* item) {
    Point14 cur;
    cur.load(item);
    const U32 ch = cur.channel();
    Point14Ctx* c = &ctx[current];
    const U32 lpr = (U32)(c->last.rn() == 1) | ((U32)(c->last.rn() >= c->last.nr()) << 1)
                    | ((U32)c->last_gps_changed << 2);
    // Flags are computed against the TARGET context's last point (fresh
    // contexts copy the previous context's last, so this is well-defined
    // before the switch happens).
    Point14Ctx* t = &ctx[ch];
    const Point14& tl = t->used ? t->last : c->last;
    const bool channel_changed = ch != current;
    const bool ps_changed = tl.point_source_id != cur.point_source_id;
    const bool gps_changed = std::memcmp(tl.gps, cur.gps, 8) != 0;
    const bool sa_changed = tl.scan_angle != cur.scan_angle;
    const bool nr_changed = tl.nr() != cur.nr();
    U32 rn_code;
    if (cur.rn() == tl.rn()) rn_code = 0;
    else if (cur.rn() == ((tl.rn() + 1) & 15)) rn_code = 1;
    else if (cur.rn() == ((tl.rn() + 15) & 15)) rn_code = 2;
    else rn_code = 3;
    const U32 cv = ((U32)channel_changed << 6) | ((U32)ps_changed << 5)
                   | ((U32)gps_changed << 4) | ((U32)sa_changed << 3)
                   | ((U32)nr_changed << 2) | rn_code;
    e[kLxy].encode_symbol(c->m_changed[lpr], cv);
    if (channel_changed) {
      e[kLxy].encode_symbol(c->m_channel, (ch - current - 1) & 3);
      if (!t->used) t->init_from(c->last, compress_mode);
      current = ch;
      c = t;
    }
    if (nr_changed) e[kLxy].encode_symbol(c->m_nr[c->last.nr()], cur.nr());
    if (rn_code == 3) {
      if (gps_changed) {
        e[kLxy].encode_symbol(c->m_rn[c->last.rn()], cur.rn());
      } else {
        e[kLxy].encode_symbol(c->m_rn_gps_same,
                              (cur.rn() - c->last.rn() - 2) & 15);
      }
    }
    const U32 nr = cur.nr(), rn = cur.rn();
    const U32 m = kNumberReturnMap[clip7(nr)][clip7(rn)];
    const U32 l = kNumberReturnLevel[clip7(nr)][clip7(rn)];

    I32 median = c->med_x[m].get();
    I32 diff = cur.x - c->last.x;
    c->ic_dx.compress(e[kLxy], median, diff, nr == 1);
    c->med_x[m].add(diff);
    median = c->med_y[m].get();
    U32 k_bits = c->ic_dx.k;
    diff = cur.y - c->last.y;
    c->ic_dy.compress(e[kLxy], median, diff,
                      (nr == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    c->med_y[m].add(diff);
    k_bits = (c->ic_dx.k + c->ic_dy.k) / 2;
    c->ic_z.compress(e[kLz], c->last_height[l], cur.z,
                     (nr == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    c->last_height[l] = cur.z;

    e[kLclass].encode_symbol(*c->lazy(c->m_class, c->last.classification, 256),
                             cur.classification);
    e[kLflags].encode_symbol(*c->lazy(c->m_flags, c->last.flags6(), 64),
                             cur.flags6());
    c->ic_intensity.compress(e[kLint], c->last_intensity[m], cur.intensity,
                             m < 3 ? m : 3u);
    c->last_intensity[m] = cur.intensity;
    if (sa_changed) {
      c->ic_scan_angle.compress(e[kLscan], c->last.scan_angle, cur.scan_angle,
                                (cur.flags6() >> 4) & 1);
    }
    e[kLuser].encode_symbol(*c->lazy(c->m_user, c->last.user_data, 256),
                            cur.user_data);
    if (ps_changed) {
      c->ic_ps.compress(e[kLps], c->last.point_source_id,
                        cur.point_source_id, 0);
    }
    if (gps_changed) c->gps.write(e[kLgps], cur.gps);
    c->last_gps_changed = gps_changed;
    c->last = cur;
  }
};

// RGB14: one layer, per-channel-context v2 RGB models.  RGBNIR14 adds a
// second layer with per-byte delta models for the NIR word.
struct Rgb14v3 {
  Rgb12v2 rgb[4];
  bool initd[4] = {};
  SymbolModel m_nir_lo[4], m_nir_hi[4];
  U16 last_nir[4];
  bool nir_alloc = false;
  bool has_nir = false;

  void init(const U8* first_item, bool cm, U32 ctx0, bool with_nir) {
    has_nir = with_nir;
    for (int c = 0; c < 4; ++c) initd[c] = false;
    rgb[ctx0].init(first_item, cm);
    initd[ctx0] = true;
    if (with_nir) {
      if (!nir_alloc) {
        for (int c = 0; c < 4; ++c) {
          m_nir_lo[c].setup(256, cm);
          m_nir_hi[c].setup(256, cm);
        }
        nir_alloc = true;
      }
      for (int c = 0; c < 4; ++c) {
        m_nir_lo[c].init();
        m_nir_hi[c].init();
        last_nir[c] = 0;
      }
      std::memcpy(&last_nir[ctx0], first_item + 6, 2);
    }
  }
  void ensure(U32 c, bool cm) {
    if (!initd[c]) {
      // Fresh context: seed from any initialised context's last value.
      U8 seed[8] = {};
      for (int s = 0; s < 4; ++s) {
        if (initd[s]) {
          std::memcpy(seed, &rgb[s].last_r, 2);
          std::memcpy(seed + 2, &rgb[s].last_g, 2);
          std::memcpy(seed + 4, &rgb[s].last_b, 2);
          if (has_nir) std::memcpy(seed + 6, &last_nir[s], 2);
          break;
        }
      }
      rgb[c].init(seed, cm);
      initd[c] = true;
      if (has_nir) std::memcpy(&last_nir[c], seed + 6, 2);
    }
  }
  void read(Decoder* d, U8* item, U32 c, bool cm) {
    ensure(c, cm);
    rgb[c].read(d[0], item);
    if (has_nir) {
      U16 nir = last_nir[c];
      U8 lo = u8_fold((I32)d[1].decode_symbol(m_nir_lo[c]) + (nir & 0xFF));
      U8 hi = u8_fold((I32)d[1].decode_symbol(m_nir_hi[c]) + (nir >> 8));
      nir = (U16)(lo | (hi << 8));
      std::memcpy(item + 6, &nir, 2);
      last_nir[c] = nir;
    }
  }
  void write(Encoder* e, const U8* item, U32 c, bool cm) {
    ensure(c, cm);
    rgb[c].write(e[0], item);
    if (has_nir) {
      U16 nir;
      std::memcpy(&nir, item + 6, 2);
      e[1].encode_symbol(m_nir_lo[c], u8_fold((I32)(nir & 0xFF) - (last_nir[c] & 0xFF)));
      e[1].encode_symbol(m_nir_hi[c], u8_fold((I32)(nir >> 8) - (last_nir[c] >> 8)));
      last_nir[c] = nir;
    }
  }
};

// BYTE14: one layer per extra byte, per-channel-context delta models.
struct Byte14v3 {
  SymbolModel* m_byte[4] = {};  // [4][count]
  U8* last[4] = {};
  U32 count = 0;
  bool used[4] = {};
  bool alloc = false;

  ~Byte14v3() {
    for (int c = 0; c < 4; ++c) {
      delete[] m_byte[c];
      delete[] last[c];
    }
  }
  void init(const U8* first_item, U32 n, bool cm, U32 ctx0) {
    if (!alloc || count != n) {
      for (int c = 0; c < 4; ++c) {
        delete[] m_byte[c];
        delete[] last[c];
        m_byte[c] = new SymbolModel[n];
        for (U32 i = 0; i < n; ++i) m_byte[c][i].setup(256, cm);
        last[c] = new U8[n];
      }
      count = n;
      alloc = true;
    }
    for (int c = 0; c < 4; ++c) used[c] = false;
    for (U32 i = 0; i < n; ++i) m_byte[ctx0][i].init();
    std::memcpy(last[ctx0], first_item, n);
    used[ctx0] = true;
  }
  void ensure(U32 c) {
    if (!used[c]) {
      for (int s = 0; s < 4; ++s) {
        if (used[s]) {
          std::memcpy(last[c], last[s], count);
          break;
        }
      }
      for (U32 i = 0; i < count; ++i) m_byte[c][i].init();
      used[c] = true;
    }
  }
  void read(Decoder* d, U8* item, U32 c) {
    ensure(c);
    for (U32 i = 0; i < count; ++i) {
      last[c][i] = u8_fold((I32)d[i].decode_symbol(m_byte[c][i]) + last[c][i]);
      item[i] = last[c][i];
    }
  }
  void write(Encoder* e, const U8* item, U32 c) {
    ensure(c);
    for (U32 i = 0; i < count; ++i) {
      e[i].encode_symbol(m_byte[c][i], u8_fold((I32)item[i] - (I32)last[c][i]));
      last[c][i] = item[i];
    }
  }
};

// ------------------------------------------------------------------------ //
// Item dispatch.  LASzip item type ids.

enum ItemType { kByte = 0, kPoint10 = 6, kGpsTime11 = 7, kRgb12 = 8 };
enum ItemType14 { kPoint14 = 10, kRgb14 = 11, kRgbNir14 = 12, kByte14 = 14 };

// Layers per layered item.
static inline I32 layers_of(I32 type, I32 size) {
  switch (type) {
    case kPoint14: return kPoint14Layers;
    case kRgb14: return 1;
    case kRgbNir14: return 2;
    case kByte14: return size;
    default: return -1;
  }
}

struct ItemCodecs {
  Point10v2 point10;
  GpsTime11v2 gpstime;
  Rgb12v2 rgb;
  Byte_v2 bytes;
};

}  // namespace

// ------------------------------------------------------------------------ //
// C API.

extern "C" {

// Decompress a pointwise-chunked (compressor 2) LASzip point stream.
//   in/in_len: the compressed stream starting at the FIRST CHUNK (just past
//     the 8-byte chunk-table offset); chunk_starts[i] = byte offset of chunk
//     i within `in` (n_chunks entries; derived from the chunk table).
//   item_types/item_sizes: the LASzip VLR item list (POINT10/GPSTIME11/
//     RGB12/BYTE only).
//   chunk_counts: per-chunk point counts for VARIABLE-chunked streams
//     (chunk_size == 0xFFFFFFFF in the VLR; counts come from the variable
//     chunk table), or NULL for fixed chunking.
//   out: n_points * point_size bytes.
// Returns 0 on success, <0 on error (-1 bad item, -2 chunk bounds).
int64_t laszip_decompress(const uint8_t* in, int64_t in_len,
                          const int32_t* item_types, const int32_t* item_sizes,
                          int32_t n_items, int64_t n_points,
                          uint32_t chunk_size, const int64_t* chunk_starts,
                          int32_t n_chunks, const int64_t* chunk_counts,
                          uint8_t* out) {
  I64 point_size = 0;
  for (I32 i = 0; i < n_items; ++i) {
    const I32 t = item_types[i];
    if (t != kPoint10 && t != kGpsTime11 && t != kRgb12 && t != kByte) return -1;
    point_size += item_sizes[i];
  }
  ItemCodecs codecs;
  Decoder dec;
  I64 p = 0;
  for (I32 c = 0; c < n_chunks && p < n_points; ++c) {
    I64 off = chunk_starts[c];
    if (off < 0 || off > in_len) return -2;
    // First point of the chunk is raw and (re)initialises every codec.
    U8* rec = out + p * point_size;
    for (I32 i = 0; i < n_items; ++i) {
      if (off + item_sizes[i] > in_len) return -2;
      std::memcpy(rec, in + off, item_sizes[i]);
      switch (item_types[i]) {
        case kPoint10: codecs.point10.init(rec, false); break;
        case kGpsTime11: codecs.gpstime.init(rec, false); break;
        case kRgb12: codecs.rgb.init(rec, false); break;
        case kByte: codecs.bytes.init(rec, item_sizes[i], false); break;
      }
      off += item_sizes[i];
      rec += item_sizes[i];
    }
    ++p;
    dec.init(in, in_len, off);
    const I64 span = chunk_counts          ? chunk_counts[c]
                     : (chunk_size == 0xFFFFFFFFu) ? n_points
                                                   : (I64)chunk_size;
    const I64 chunk_end =
        ((p - 1) + span < n_points ? (p - 1) + span : n_points);
    for (; p < chunk_end; ++p) {
      rec = out + p * point_size;
      for (I32 i = 0; i < n_items; ++i) {
        switch (item_types[i]) {
          case kPoint10: codecs.point10.read(dec, rec); break;
          case kGpsTime11: codecs.gpstime.read(dec, rec); break;
          case kRgb12: codecs.rgb.read(dec, rec); break;
          case kByte: codecs.bytes.read(dec, rec); break;
        }
        rec += item_sizes[i];
      }
    }
  }
  return p == n_points ? 0 : -3;
}

// Compress points into a pointwise-chunked LASzip stream (no chunk-table
// framing — the caller assembles offset field + stream + chunk table).
// chunk_bytes_out[i] receives the byte length of chunk i (capacity must be
// >= ceil(n_points/chunk_size)).  chunk_counts (or NULL for fixed chunking)
// gives explicit per-chunk point counts for a VARIABLE-chunked stream; the
// counts must sum to >= n_points.  Returns total bytes written, or -1 if
// out_cap was too small (re-call with a larger buffer), -2 on a bad item.
int64_t laszip_compress(const uint8_t* in, int64_t n_points,
                        const int32_t* item_types, const int32_t* item_sizes,
                        int32_t n_items, uint32_t chunk_size,
                        const int64_t* chunk_counts, uint8_t* out,
                        int64_t out_cap, int64_t* chunk_bytes_out,
                        int32_t* n_chunks_out) {
  I64 point_size = 0;
  for (I32 i = 0; i < n_items; ++i) {
    const I32 t = item_types[i];
    if (t != kPoint10 && t != kGpsTime11 && t != kRgb12 && t != kByte) return -2;
    point_size += item_sizes[i];
  }
  ItemCodecs codecs;
  Encoder enc;
  I64 pos = 0;
  I32 n_chunks = 0;
  I64 p = 0;
  while (p < n_points) {
    const I64 chunk_start = pos;
    const U8* rec = in + p * point_size;
    for (I32 i = 0; i < n_items; ++i) {
      if (pos + item_sizes[i] <= out_cap) std::memcpy(out + pos, rec, item_sizes[i]);
      switch (item_types[i]) {
        case kPoint10: codecs.point10.init(rec, true); break;
        case kGpsTime11: codecs.gpstime.init(rec, true); break;
        case kRgb12: codecs.rgb.init(rec, true); break;
        case kByte: codecs.bytes.init(rec, item_sizes[i], true); break;
      }
      pos += item_sizes[i];
      rec += item_sizes[i];
    }
    ++p;
    enc.init(out, out_cap, pos);
    const I64 span = chunk_counts          ? chunk_counts[n_chunks]
                     : (chunk_size == 0xFFFFFFFFu) ? n_points
                                                   : (I64)chunk_size;
    const I64 chunk_end =
        ((p - 1) + span < n_points ? (p - 1) + span : n_points);
    for (; p < chunk_end; ++p) {
      rec = in + p * point_size;
      for (I32 i = 0; i < n_items; ++i) {
        switch (item_types[i]) {
          case kPoint10: codecs.point10.write(enc, rec); break;
          case kGpsTime11: codecs.gpstime.write(enc, rec); break;
          case kRgb12: codecs.rgb.write(enc, rec); break;
          case kByte: codecs.bytes.write(enc, rec); break;
        }
        rec += item_sizes[i];
      }
    }
    enc.done();
    pos = enc.pos;
    chunk_bytes_out[n_chunks++] = pos - chunk_start;
    if (enc.overflow || pos > out_cap) return -1;
  }
  *n_chunks_out = n_chunks;
  return pos;
}

// Chunk table payload codec (the arithmetic-coded part AFTER the
// u32 version / u32 number_chunks header words).
// Decode: fills chunk_bytes_out[n_chunks]; returns 0 or <0.
int64_t laszip_read_chunk_table(const uint8_t* in, int64_t in_len,
                                int32_t n_chunks, int64_t* chunk_bytes_out) {
  Decoder dec;
  dec.init(in, in_len, 0);
  IntegerCompressor ic(32, 2);
  ic.setup(false);
  I32 prev = 0;
  for (I32 i = 0; i < n_chunks; ++i) {
    const I32 v = ic.decompress(dec, prev, 1);
    chunk_bytes_out[i] = (I64)(U32)v;
    prev = v;
  }
  return 0;
}

// Encode: writes the arithmetic-coded payload; returns bytes written or -1
// if cap too small.
int64_t laszip_write_chunk_table(const int64_t* chunk_bytes, int32_t n_chunks,
                                 uint8_t* out, int64_t cap) {
  Encoder enc;
  enc.init(out, cap, 0);
  IntegerCompressor ic(32, 2);
  ic.setup(true);
  I32 prev = 0;
  for (I32 i = 0; i < n_chunks; ++i) {
    const I32 v = (I32)(U32)chunk_bytes[i];
    ic.compress(enc, prev, v, 1);
    prev = v;
  }
  enc.done();
  return enc.overflow ? -1 : enc.pos;
}

// VARIABLE-chunked table payload (VLR chunk_size == 0xFFFFFFFF): each entry
// carries the chunk's point COUNT (IC context 0) then its byte size (IC
// context 1), both predicted from the previous entry's raw value — the
// layout LASzip's read_chunk_table uses when chunk totals are present.
int64_t laszip_read_chunk_table_variable(const uint8_t* in, int64_t in_len,
                                         int32_t n_chunks,
                                         int64_t* chunk_counts_out,
                                         int64_t* chunk_bytes_out) {
  Decoder dec;
  dec.init(in, in_len, 0);
  IntegerCompressor ic(32, 2);
  ic.setup(false);
  I32 prev_count = 0;
  I32 prev_bytes = 0;
  for (I32 i = 0; i < n_chunks; ++i) {
    const I32 cnt = ic.decompress(dec, prev_count, 0);
    const I32 nb = ic.decompress(dec, prev_bytes, 1);
    chunk_counts_out[i] = (I64)(U32)cnt;
    chunk_bytes_out[i] = (I64)(U32)nb;
    prev_count = cnt;
    prev_bytes = nb;
  }
  return 0;
}

int64_t laszip_write_chunk_table_variable(const int64_t* chunk_counts,
                                          const int64_t* chunk_bytes,
                                          int32_t n_chunks, uint8_t* out,
                                          int64_t cap) {
  Encoder enc;
  enc.init(out, cap, 0);
  IntegerCompressor ic(32, 2);
  ic.setup(true);
  I32 prev_count = 0;
  I32 prev_bytes = 0;
  for (I32 i = 0; i < n_chunks; ++i) {
    const I32 cnt = (I32)(U32)chunk_counts[i];
    const I32 nb = (I32)(U32)chunk_bytes[i];
    ic.compress(enc, prev_count, cnt, 0);
    ic.compress(enc, prev_bytes, nb, 1);
    prev_count = cnt;
    prev_bytes = nb;
  }
  enc.done();
  return enc.overflow ? -1 : enc.pos;
}

// ------------------------------------------------------------------------ //
// Layered (compressor 3) entry points for LAS 1.4 point formats 6-10.
//
// Per-chunk stream layout: [raw first point (all items, item order)]
// [u32 little-endian byte count per layer, item/layer order]
// [layer payloads, same order].  Chunk table framing is compressor 2's.

namespace {

struct LayeredCodecs {
  Point14v3 point14;
  Rgb14v3 rgb14;
  Byte14v3 byte14;
};

}  // namespace

// Decompress a layered LASzip point stream (items POINT14/RGB14/RGBNIR14/
// BYTE14 only).  Same calling convention as laszip_decompress.
// Returns 0, or <0 on error (-1 bad item, -2 bounds).
int64_t laszip_decompress_layered(const uint8_t* in, int64_t in_len,
                                  const int32_t* item_types,
                                  const int32_t* item_sizes, int32_t n_items,
                                  int64_t n_points, uint32_t chunk_size,
                                  const int64_t* chunk_starts,
                                  int32_t n_chunks, const int64_t* chunk_counts,
                                  uint8_t* out) {
  I64 point_size = 0;
  I32 total_layers = 0;
  for (I32 i = 0; i < n_items; ++i) {
    const I32 nl = layers_of(item_types[i], item_sizes[i]);
    if (nl < 0) return -1;
    total_layers += nl;
    point_size += item_sizes[i];
  }
  // Variable chunking needs the per-chunk counts from the chunk table.
  if (chunk_size == 0xFFFFFFFFu && !chunk_counts) return -4;
  LayeredCodecs codecs;
  std::vector<Decoder> dec(total_layers);
  I64 p = 0;
  for (I32 c = 0; c < n_chunks && p < n_points; ++c) {
    I64 off = chunk_starts[c];
    if (off < 0 || off > in_len) return -2;
    // Raw first point; (re)initialises every codec.
    U8* rec = out + p * point_size;
    U8 first_channel = 0;
    {
      const U8* fp = in + off;
      for (I32 i = 0; i < n_items; ++i) {
        if (item_types[i] == kPoint14) first_channel = (U8)((fp[15] >> 4) & 3);
        fp += item_sizes[i];
      }
    }
    for (I32 i = 0; i < n_items; ++i) {
      if (off + item_sizes[i] > in_len) return -2;
      std::memcpy(rec, in + off, item_sizes[i]);
      switch (item_types[i]) {
        case kPoint14: codecs.point14.init(rec, false); break;
        case kRgb14: codecs.rgb14.init(rec, false, first_channel, false); break;
        case kRgbNir14: codecs.rgb14.init(rec, false, first_channel, true); break;
        case kByte14: codecs.byte14.init(rec, item_sizes[i], false, first_channel); break;
      }
      off += item_sizes[i];
      rec += item_sizes[i];
    }
    ++p;
    // Layer byte counts, then per-layer decoders over the payloads.
    if (off + 4 * (I64)total_layers > in_len) return -2;
    I64 pay = off + 4 * (I64)total_layers;
    for (I32 j = 0; j < total_layers; ++j) {
      U32 nbytes;
      std::memcpy(&nbytes, in + off + 4 * (I64)j, 4);
      if (pay + nbytes > in_len) return -2;
      dec[j].init(in, pay + nbytes, pay);
      pay += nbytes;
    }
    const I64 span = chunk_counts ? chunk_counts[c] : (I64)chunk_size;
    const I64 chunk_end =
        ((p - 1) + span < n_points ? (p - 1) + span : n_points);
    for (; p < chunk_end; ++p) {
      rec = out + p * point_size;
      I32 lj = 0;
      U32 pt_ctx = codecs.point14.current;
      for (I32 i = 0; i < n_items; ++i) {
        switch (item_types[i]) {
          case kPoint14:
            codecs.point14.read(&dec[lj], rec);
            pt_ctx = codecs.point14.current;
            break;
          case kRgb14:
            codecs.rgb14.read(&dec[lj], rec, pt_ctx, false);
            break;
          case kRgbNir14:
            codecs.rgb14.read(&dec[lj], rec, pt_ctx, false);
            break;
          case kByte14:
            codecs.byte14.read(&dec[lj], rec, pt_ctx);
            break;
        }
        lj += layers_of(item_types[i], item_sizes[i]);
        rec += item_sizes[i];
      }
    }
  }
  return p == n_points ? 0 : -3;
}

// Compress points into a layered LASzip stream.  Same calling convention as
// laszip_compress.  Returns total bytes, -1 if out_cap too small, -2 bad item.
int64_t laszip_compress_layered(const uint8_t* in, int64_t n_points,
                                const int32_t* item_types,
                                const int32_t* item_sizes, int32_t n_items,
                                uint32_t chunk_size, const int64_t* chunk_counts,
                                uint8_t* out,
                                int64_t out_cap, int64_t* chunk_bytes_out,
                                int32_t* n_chunks_out) {
  I64 point_size = 0;
  I32 total_layers = 0;
  for (I32 i = 0; i < n_items; ++i) {
    const I32 nl = layers_of(item_types[i], item_sizes[i]);
    if (nl < 0) return -2;
    total_layers += nl;
    point_size += item_sizes[i];
  }
  if (chunk_size == 0xFFFFFFFFu && !chunk_counts) return -4;
  LayeredCodecs codecs;
  std::vector<Encoder> enc(total_layers);
  std::vector<std::vector<U8>> bufs(total_layers);
  I64 pos = 0;
  I32 n_chunks = 0;
  I64 p = 0;
  while (p < n_points) {
    const I64 chunk_start = pos;
    const I64 span = chunk_counts ? chunk_counts[n_chunks] : (I64)chunk_size;
    const I64 pts_here = span < n_points - p ? span : n_points - p;
    // Worst-case per-layer budget: a layer never exceeds its field's raw
    // bytes by more than the coder's constant tail.
    for (I32 j = 0, i = 0; i < n_items; ++i) {
      const I32 nl = layers_of(item_types[i], item_sizes[i]);
      const I64 cap = pts_here * (item_sizes[i] + 2) + 4096;
      for (I32 l = 0; l < nl; ++l, ++j) {
        if ((I64)bufs[j].size() < cap) bufs[j].resize(cap);
        enc[j].init(bufs[j].data(), cap, 0);
      }
    }
    const U8* rec = in + p * point_size;
    U8 first_channel = 0;
    {
      const U8* fp = rec;
      for (I32 i = 0; i < n_items; ++i) {
        if (item_types[i] == kPoint14) first_channel = (U8)((fp[15] >> 4) & 3);
        fp += item_sizes[i];
      }
    }
    for (I32 i = 0; i < n_items; ++i) {
      if (pos + item_sizes[i] <= out_cap) std::memcpy(out + pos, rec, item_sizes[i]);
      switch (item_types[i]) {
        case kPoint14: codecs.point14.init(rec, true); break;
        case kRgb14: codecs.rgb14.init(rec, true, first_channel, false); break;
        case kRgbNir14: codecs.rgb14.init(rec, true, first_channel, true); break;
        case kByte14: codecs.byte14.init(rec, item_sizes[i], true, first_channel); break;
      }
      pos += item_sizes[i];
      rec += item_sizes[i];
    }
    ++p;
    const I64 chunk_end =
        ((p - 1) + span < n_points ? (p - 1) + span : n_points);
    for (; p < chunk_end; ++p) {
      rec = in + p * point_size;
      I32 lj = 0;
      U32 pt_ctx = codecs.point14.current;
      for (I32 i = 0; i < n_items; ++i) {
        switch (item_types[i]) {
          case kPoint14:
            codecs.point14.write(&enc[lj], rec);
            pt_ctx = codecs.point14.current;
            break;
          case kRgb14:
            codecs.rgb14.write(&enc[lj], rec, pt_ctx, true);
            break;
          case kRgbNir14:
            codecs.rgb14.write(&enc[lj], rec, pt_ctx, true);
            break;
          case kByte14:
            codecs.byte14.write(&enc[lj], rec, pt_ctx);
            break;
        }
        lj += layers_of(item_types[i], item_sizes[i]);
        rec += item_sizes[i];
      }
    }
    // Finish layers; write [sizes][payloads].
    for (I32 j = 0; j < total_layers; ++j) {
      enc[j].done();
      if (enc[j].overflow) return -1;
      const U32 nbytes = (U32)enc[j].pos;
      if (pos + 4 <= out_cap) std::memcpy(out + pos, &nbytes, 4);
      pos += 4;
    }
    for (I32 j = 0; j < total_layers; ++j) {
      const I64 nbytes = enc[j].pos;
      if (pos + nbytes <= out_cap) std::memcpy(out + pos, bufs[j].data(), nbytes);
      pos += nbytes;
    }
    chunk_bytes_out[n_chunks++] = pos - chunk_start;
    if (pos > out_cap) return -1;
  }
  *n_chunks_out = n_chunks;
  return pos;
}

}  // extern "C"
