// Independent BCn block decoder (BC1-BC7, BC6H), written from the public
// D3D11 functional spec / Khronos BPTC extension text.
//
// Purpose: a second, native implementation of the decode semantics that the
// PyTorch decoders in ../decode/ also implement. Tests and the smoke run
// cross-check both so a shared misunderstanding of the spec cannot hide (the
// reference ships no decoder at all - SURVEY.md §4).
//
// Interpolation conventions for the formats whose precision is
// implementation-defined (BC1 thirds, BC4 sevenths/fifths) follow the
// framework's documented choice (decode/bcn.py): round-to-nearest integer.
// BC7 and BC6H are exactly specified by the spec and carry no convention.
//
// Build: ../native.py compiles this file with g++ -O2 -fPIC -shared at first
// use and loads it with ctypes. bc6h_layouts.inc is generated by
// gen_bc6h_layouts.py from ../tables/bc6h_tables.py.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- helpers --
static inline uint32_t get_bits(const uint8_t *b, int start, int n) {
  // little-endian bit order within the 8/16-byte block
  uint32_t v = 0;
  for (int i = 0; i < n; i++) {
    int bit = start + i;
    v |= (uint32_t)((b[bit >> 3] >> (bit & 7)) & 1) << i;
  }
  return v;
}

// ------------------------------------------------------------------- BC1 ---
static void expand565(uint32_t c, int *r, int *g, int *bch) {
  int r5 = (c >> 11) & 31, g6 = (c >> 5) & 63, b5 = c & 31;
  *r = (r5 << 3) | (r5 >> 2);
  *g = (g6 << 2) | (g6 >> 4);
  *bch = (b5 << 3) | (b5 >> 2);
}

// out: 16 * RGBA bytes
void decode_bc1_block(const uint8_t *blk, uint8_t *out, int force_four) {
  uint32_t c0 = blk[0] | (blk[1] << 8);
  uint32_t c1 = blk[2] | (blk[3] << 8);
  int r0, g0, b0, r1, g1, b1;
  expand565(c0, &r0, &g0, &b0);
  expand565(c1, &r1, &g1, &b1);
  int pal[4][4];
  pal[0][0] = r0; pal[0][1] = g0; pal[0][2] = b0; pal[0][3] = 255;
  pal[1][0] = r1; pal[1][1] = g1; pal[1][2] = b1; pal[1][3] = 255;
  if (force_four || c0 > c1) {
    pal[2][0] = (2 * r0 + r1 + 1) / 3; pal[2][1] = (2 * g0 + g1 + 1) / 3;
    pal[2][2] = (2 * b0 + b1 + 1) / 3; pal[2][3] = 255;
    pal[3][0] = (r0 + 2 * r1 + 1) / 3; pal[3][1] = (g0 + 2 * g1 + 1) / 3;
    pal[3][2] = (b0 + 2 * b1 + 1) / 3; pal[3][3] = 255;
  } else {
    pal[2][0] = (r0 + r1 + 1) / 2; pal[2][1] = (g0 + g1 + 1) / 2;
    pal[2][2] = (b0 + b1 + 1) / 2; pal[2][3] = 255;
    pal[3][0] = 0; pal[3][1] = 0; pal[3][2] = 0; pal[3][3] = 0;
  }
  uint32_t idx = blk[4] | (blk[5] << 8) | ((uint32_t)blk[6] << 16) |
                 ((uint32_t)blk[7] << 24);
  for (int i = 0; i < 16; i++) {
    int k = (idx >> (2 * i)) & 3;
    out[i * 4 + 0] = (uint8_t)pal[k][0];
    out[i * 4 + 1] = (uint8_t)pal[k][1];
    out[i * 4 + 2] = (uint8_t)pal[k][2];
    out[i * 4 + 3] = (uint8_t)pal[k][3];
  }
}

// ------------------------------------------------------------------- BC4 ---
// out: 16 bytes (single channel)
void decode_bc4_block(const uint8_t *blk, uint8_t *out) {
  int a0 = blk[0], a1 = blk[1];
  int pal[8];
  pal[0] = a0;
  pal[1] = a1;
  if (a0 > a1) {
    for (int i = 2; i < 8; i++)
      pal[i] = ((8 - i) * a0 + (i - 1) * a1 + 3) / 7;
  } else {
    for (int i = 2; i < 6; i++)
      pal[i] = ((6 - i) * a0 + (i - 1) * a1 + 2) / 5;
    pal[6] = 0;
    pal[7] = 255;
  }
  for (int i = 0; i < 16; i++)
    out[i] = (uint8_t)pal[get_bits(blk, 16 + 3 * i, 3)];
}

void decode_bc2_alpha_block(const uint8_t *blk, uint8_t *out) {
  for (int i = 0; i < 16; i++) {
    int q = get_bits(blk, 4 * i, 4);
    out[i] = (uint8_t)(q * 17);
  }
}

void decode_bc2_block(const uint8_t *blk, uint8_t *out) {
  decode_bc1_block(blk + 8, out, 1);
  uint8_t a[16];
  decode_bc2_alpha_block(blk, a);
  for (int i = 0; i < 16; i++) out[i * 4 + 3] = a[i];
}

void decode_bc3_block(const uint8_t *blk, uint8_t *out) {
  decode_bc1_block(blk + 8, out, 1);
  uint8_t a[16];
  decode_bc4_block(blk, a);
  for (int i = 0; i < 16; i++) out[i * 4 + 3] = a[i];
}

// out: 16 * 2 bytes (R, G)
void decode_bc5_block(const uint8_t *blk, uint8_t *out) {
  uint8_t r[16], g[16];
  decode_bc4_block(blk, r);
  decode_bc4_block(blk + 8, g);
  for (int i = 0; i < 16; i++) {
    out[i * 2 + 0] = r[i];
    out[i * 2 + 1] = g[i];
  }
}

// ------------------------------------------------------------------- BC7 ---
static const uint16_t kP2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
static const uint32_t kP3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050,
    0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090,
    0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054,
    0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
    0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
    0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424,
    0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
    0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580,
    0xAA141414, 0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254};
static const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
static const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
static const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
static const uint8_t kW2[4] = {0, 21, 43, 64};
static const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                                34, 38, 43, 47, 51, 55, 60, 64};

struct Bc7ModeInfo {
  int subsets, pbits /*partition bits*/, rot, idxmode;
  int cb, ab;            // colour/alpha endpoint bits
  int pbit_mode;         // 0 none, 1 per-endpoint, 2 shared
  int ib, ib2;           // index widths
};
static const Bc7ModeInfo kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 3, 0}, {2, 6, 0, 0, 6, 0, 2, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 2, 0}};

static inline int dequant(int v, int bits) {
  int x = v << (8 - bits);
  return x | (x >> bits);
}
static inline int lerp64(int a, int b, int w) {
  return (a * (64 - w) + b * w + 32) >> 6;
}

// out: 16 * RGBA bytes
void decode_bc7_block(const uint8_t *blk, uint8_t *out) {
  int mode = 0;
  while (mode < 8 && !((blk[0] >> mode) & 1)) mode++;
  if (mode == 8) {            // invalid: transparent black per spec
    memset(out, 0, 64);
    return;
  }
  const Bc7ModeInfo &m = kBc7Modes[mode];
  int pos = mode + 1;
  int part = 0, rot = 0, idxmode = 0;
  if (m.pbits) { part = get_bits(blk, pos, m.pbits); pos += m.pbits; }
  if (m.rot) { rot = get_bits(blk, pos, m.rot); pos += m.rot; }
  if (m.idxmode) { idxmode = get_bits(blk, pos, 1); pos += 1; }

  int neps = 2 * m.subsets;
  int chans = m.ab ? 4 : 3;
  int raw[4][6];  // [channel][endpoint]
  for (int c = 0; c < 3; c++)
    for (int e = 0; e < neps; e++) {
      raw[c][e] = get_bits(blk, pos, m.cb);
      pos += m.cb;
    }
  if (m.ab)
    for (int e = 0; e < neps; e++) {
      raw[3][e] = get_bits(blk, pos, m.ab);
      pos += m.ab;
    }
  int pb[6] = {0, 0, 0, 0, 0, 0};
  if (m.pbit_mode == 1) {
    for (int e = 0; e < neps; e++) { pb[e] = get_bits(blk, pos, 1); pos++; }
  } else if (m.pbit_mode == 2) {
    for (int s = 0; s < m.subsets; s++) {
      int p = get_bits(blk, pos, 1); pos++;
      pb[2 * s] = pb[2 * s + 1] = p;
    }
  }
  int eps[6][4];
  for (int e = 0; e < neps; e++) {
    for (int c = 0; c < chans; c++) {
      int bits = (c < 3) ? m.cb : m.ab;
      int v = raw[c][e];
      if (m.pbit_mode) { v = (v << 1) | pb[e]; bits += 1; }
      eps[e][c] = dequant(v, bits);
    }
    if (chans == 3) eps[e][3] = 255;
  }

  // subset + anchor of each pixel
  int sub[16], anchors[3] = {0, 0, 0};
  if (m.subsets == 1) {
    for (int i = 0; i < 16; i++) sub[i] = 0;
  } else if (m.subsets == 2) {
    for (int i = 0; i < 16; i++) sub[i] = (kP2[part] >> i) & 1;
    anchors[1] = kAnchor2[part];
  } else {
    for (int i = 0; i < 16; i++) sub[i] = (kP3[part] >> (2 * i)) & 3;
    anchors[1] = kAnchor3a[part];
    anchors[2] = kAnchor3b[part];
  }

  int idx1[16];
  for (int i = 0; i < 16; i++) {
    int w = m.ib;
    for (int s = 0; s < m.subsets; s++)
      if (anchors[s] == i && sub[i] == s) w -= 1;
    idx1[i] = get_bits(blk, pos, w);
    pos += w;
  }
  int idx2[16];
  if (m.ib2) {
    for (int i = 0; i < 16; i++) {
      int w = m.ib2 - (i == 0 ? 1 : 0);
      idx2[i] = get_bits(blk, pos, w);
      pos += w;
    }
  }

  const uint8_t *wt1 = m.ib == 2 ? kW2 : (m.ib == 3 ? kW3 : kW4);
  const uint8_t *wt2 = m.ib2 == 2 ? kW2 : kW3;
  for (int i = 0; i < 16; i++) {
    int s = sub[i];
    const int *e0 = eps[2 * s], *e1 = eps[2 * s + 1];
    int px[4];
    if (m.ib2) {
      int ci = idxmode ? idx2[i] : idx1[i];
      int ai = idxmode ? idx1[i] : idx2[i];
      int cw = idxmode ? wt2[ci] : wt1[ci];
      int aw = idxmode ? wt1[ai] : wt2[ai];
      for (int c = 0; c < 3; c++) px[c] = lerp64(e0[c], e1[c], cw);
      px[3] = lerp64(e0[3], e1[3], aw);
      if (rot) { int t = px[rot - 1]; px[rot - 1] = px[3]; px[3] = t; }
    } else {
      for (int c = 0; c < 4; c++) px[c] = lerp64(e0[c], e1[c], wt1[idx1[i]]);
    }
    for (int c = 0; c < 4; c++) out[i * 4 + c] = (uint8_t)px[c];
  }
}

// ------------------------------------------------------------------ BC6H ---
struct Bc6hModeInfo {
  int code, code_bits, base, db[3], transformed, regions;
};
static const Bc6hModeInfo kBc6hModes[14] = {
    {0x00, 2, 10, {5, 5, 5}, 1, 2},   {0x01, 2, 7, {6, 6, 6}, 1, 2},
    {0x02, 5, 11, {5, 4, 4}, 1, 2},   {0x06, 5, 11, {4, 5, 4}, 1, 2},
    {0x0A, 5, 11, {4, 4, 5}, 1, 2},   {0x0E, 5, 9, {5, 5, 5}, 1, 2},
    {0x12, 5, 8, {6, 5, 5}, 1, 2},    {0x16, 5, 8, {5, 6, 5}, 1, 2},
    {0x1A, 5, 8, {5, 5, 6}, 1, 2},    {0x1E, 5, 6, {6, 6, 6}, 0, 2},
    {0x03, 5, 10, {10, 10, 10}, 0, 1}, {0x07, 5, 11, {9, 9, 9}, 1, 1},
    {0x0B, 5, 12, {8, 8, 8}, 1, 1},   {0x0F, 5, 16, {4, 4, 4}, 1, 1}};

// field segment: field id (0..11: rw gw bw rx gx bx ry gy by rz gz bz),
// src bit, dst bit, width. Generated from the spec layout (shared with the
// Python tables; see tables/bc6h_tables.py).
struct Seg { uint8_t f, src, dst, n; };
#include "bc6h_layouts.inc"

static inline int sext(int v, int bits) {
  int s = 1 << (bits - 1);
  return (v ^ s) - s;
}
static int unquant_u(int q, int prec) {
  if (prec >= 15) return q;
  if (q == 0) return 0;
  if (q == (1 << prec) - 1) return 0xFFFF;
  return ((q << 16) + 0x8000) >> prec;
}
static int unquant_s(int q, int prec) {
  if (prec >= 16) return q;
  int s = q < 0;
  int a = s ? -q : q;
  int maxa = (1 << (prec - 1)) - 1;
  int u;
  if (a == 0) u = 0;
  else if (a >= maxa) u = 0x7FFF;
  else u = ((a << 15) + 0x4000) >> (prec - 1);
  return s ? -u : u;
}
static int finish(int v, int is_signed) {
  if (!is_signed) return (v * 31) >> 6;
  int mag = ((v < 0 ? -v : v) * 31) >> 5;
  return v < 0 ? (mag | 0x8000) : mag;
}

// out: 16 * 3 uint16 half-bit patterns
void decode_bc6h_block(const uint8_t *blk, uint16_t *out, int is_signed) {
  int code2 = blk[0] & 3, code5 = blk[0] & 31;
  int mi = -1;
  for (int i = 0; i < 14; i++) {
    const Bc6hModeInfo &m = kBc6hModes[i];
    if ((m.code_bits == 2 && code2 == m.code) ||
        (m.code_bits == 5 && code5 == m.code)) { mi = i; break; }
  }
  if (mi < 0) { memset(out, 0, 96); return; }
  const Bc6hModeInfo &m = kBc6hModes[mi];

  int fields[12] = {0};
  const Seg *segs = kBc6hLayouts[mi];
  for (int i = 0; kBc6hLayouts[mi][i].n != 0; i++) {
    const Seg &s = segs[i];
    fields[s.f] |= (int)get_bits(blk, s.dst, s.n) << s.src;
  }
  int prec = m.base;
  int e[4][3];
  for (int c = 0; c < 3; c++) {
    int w = fields[c];
    if (is_signed) w = sext(w, prec);
    e[0][c] = w;
    for (int j = 1; j < 4; j++) {
      int raw = fields[3 * j + c];
      int db = m.db[c];
      int v;
      if (m.transformed) {
        v = (w + sext(raw, db)) & ((1 << prec) - 1);
        if (is_signed) v = sext(v, prec);
      } else {
        v = is_signed ? sext(raw, db) : raw;
      }
      e[j][c] = v;
    }
  }
  int u[4][3];
  for (int j = 0; j < 4; j++)
    for (int c = 0; c < 3; c++)
      u[j][c] = is_signed ? unquant_s(e[j][c], prec) : unquant_u(e[j][c], prec);

  if (m.regions == 2) {
    int shape = get_bits(blk, 77, 5);
    int anchor1 = kAnchor2[shape];
    int pos = 82;
    for (int i = 0; i < 16; i++) {
      int s = (kP2[shape] >> i) & 1;
      int w = (i == 0 || i == anchor1) ? 2 : 3;
      int idx = get_bits(blk, pos, w);
      pos += w;
      for (int c = 0; c < 3; c++) {
        int v = lerp64(u[s ? 2 : 0][c], u[s ? 3 : 1][c], kW3[idx]);
        out[i * 3 + c] = (uint16_t)finish(v, is_signed);
      }
    }
  } else {
    int pos = 65;
    for (int i = 0; i < 16; i++) {
      int w = (i == 0) ? 3 : 4;
      int idx = get_bits(blk, pos, w);
      pos += w;
      for (int c = 0; c < 3; c++) {
        int v = lerp64(u[0][c], u[1][c], kW4[idx]);
        out[i * 3 + c] = (uint16_t)finish(v, is_signed);
      }
    }
  }
}

// -------------------------------------------------------- batch wrappers ---
void decode_bc1(const uint8_t *blocks, uint8_t *out, int n, int force_four) {
  for (int i = 0; i < n; i++)
    decode_bc1_block(blocks + i * 8, out + i * 64, force_four);
}
void decode_bc2(const uint8_t *blocks, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) decode_bc2_block(blocks + i * 16, out + i * 64);
}
void decode_bc3(const uint8_t *blocks, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) decode_bc3_block(blocks + i * 16, out + i * 64);
}
void decode_bc4(const uint8_t *blocks, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) decode_bc4_block(blocks + i * 8, out + i * 16);
}
void decode_bc5(const uint8_t *blocks, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) decode_bc5_block(blocks + i * 16, out + i * 32);
}
void decode_bc7(const uint8_t *blocks, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) decode_bc7_block(blocks + i * 16, out + i * 64);
}
void decode_bc6h(const uint8_t *blocks, uint16_t *out, int n, int is_signed) {
  for (int i = 0; i < n; i++)
    decode_bc6h_block(blocks + i * 16, out + i * 48, is_signed);
}

}  // extern "C"
