/* Native snappy block-format codec (+ CRC32C).
 *
 * Role of the reference's `snap` dependency (rpc/codec/ssz_snappy.rs,
 * gossip compression): raw snappy block compress/uncompress with a
 * greedy hash-table matcher (the classic snappy algorithm), plus
 * CRC32C (Castagnoli) for the snappy frame format's masked checksums.
 *
 * Format recap: preamble = varint uncompressed length; body = elements:
 *   tag & 3 == 0: literal, length (tag>>2)+1 (60..63 escape to 1-4
 *                 extra length bytes)
 *   tag & 3 == 1: copy, 4..11 bytes long, offset 11 bits
 *   tag & 3 == 2: copy, 1..64 bytes, offset 16 bits (little-endian)
 *   tag & 3 == 3: copy, offset 32 bits (emitted only for huge inputs)
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define HASH_BITS 14
#define HASH_SIZE (1 << HASH_BITS)

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - HASH_BITS);
}

static uint8_t* emit_varint(uint8_t* dst, uint32_t v) {
  while (v >= 0x80) {
    *dst++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *dst++ = (uint8_t)v;
  return dst;
}

static uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, uint32_t len) {
  uint32_t n = len - 1;
  if (n < 60) {
    *dst++ = (uint8_t)(n << 2);
  } else if (n < (1u << 8)) {
    *dst++ = 60 << 2;
    *dst++ = (uint8_t)n;
  } else if (n < (1u << 16)) {
    *dst++ = 61 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
  } else if (n < (1u << 24)) {
    *dst++ = 62 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
  } else {
    *dst++ = 63 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
    *dst++ = (uint8_t)(n >> 24);
  }
  memcpy(dst, src, len);
  return dst + len;
}

static uint8_t* emit_copy(uint8_t* dst, uint32_t offset, uint32_t len) {
  /* prefer 64-byte chunks with 2-byte-offset copies */
  while (len >= 68) {
    *dst++ = (2) | ((64 - 1) << 2);
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    len -= 64;
  }
  if (len > 64) {
    /* emit 60 to leave >= 4 for the final copy */
    *dst++ = (2) | ((60 - 1) << 2);
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    len -= 60;
  }
  if (len >= 12 || offset >= 2048) {
    *dst++ = (2) | ((uint8_t)(len - 1) << 2);
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
  } else {
    /* 1-byte-offset copy: len 4..11, offset < 2048 */
    *dst++ = (1) | ((uint8_t)(len - 4) << 2) | ((uint8_t)(offset >> 8) << 5);
    *dst++ = (uint8_t)offset;
  }
  return dst;
}

/* worst-case output bound (snappy MaxCompressedLength formula) */
uint32_t snappy_max_compressed(uint32_t n) { return 32 + n + n / 6; }

/* returns compressed size, or 0 on error */
uint32_t snappy_compress(const uint8_t* src, uint32_t n, uint8_t* dst) {
  uint8_t* out = emit_varint(dst, n);
  if (n == 0) return (uint32_t)(out - dst);
  uint16_t table[HASH_SIZE];
  memset(table, 0, sizeof(table));
  /* table stores position+1 within the current 64KB-ish window baseline */
  uint32_t ip = 0, anchor = 0;
  uint32_t base = 0; /* positions in table are relative to base */
  while (n - ip >= 4) {
    uint32_t h = hash32(load32(src + ip));
    uint32_t slot = table[h]; /* 0 = empty; else position - base + 1 */
    table[h] = (uint16_t)(ip - base + 1);
    if (slot > 0) {
      uint32_t c = base + slot - 1;
      if (c < ip && ip - c <= 65535 && load32(src + c) == load32(src + ip)) {
        /* match: emit pending literal then extend */
        if (ip > anchor) out = emit_literal(out, src + anchor, ip - anchor);
        uint32_t len = 4;
        while (ip + len < n && src[c + len] == src[ip + len]) len++;
        out = emit_copy(out, ip - c, len);
        ip += len;
        anchor = ip;
        continue;
      }
    }
    ip++;
    if (ip - base > 60000) {
      /* rebase the 16-bit table window (slot values must fit uint16) */
      memset(table, 0, sizeof(table));
      base = ip;
    }
  }
  if (anchor < n) out = emit_literal(out, src + anchor, n - anchor);
  return (uint32_t)(out - dst);
}

/* returns uncompressed size, or -1 on malformed input. All bounds
 * checks compare REMAINING capacity (len > n - ip), never ip + len,
 * which an attacker-controlled 32-bit len could wrap past the end. */
int64_t snappy_uncompress(const uint8_t* src, uint32_t n, uint8_t* dst,
                          uint32_t dst_cap) {
  uint32_t ip = 0, expect = 0, shift = 0;
  /* varint preamble */
  for (;;) {
    if (ip >= n || shift > 28) return -1;
    uint8_t b = src[ip++];
    expect |= (uint32_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (expect > dst_cap) return -1;
  uint32_t op = 0;
  while (ip < n) {
    uint8_t tag = src[ip++];
    uint32_t len, offset;
    switch (tag & 3) {
      case 0: {
        len = (tag >> 2) + 1;
        if (len > 60) {
          uint32_t extra = len - 60;
          if (extra > n - ip) return -1;
          len = 0;
          for (uint32_t i = 0; i < extra; i++) len |= (uint32_t)src[ip + i] << (8 * i);
          if (len == 0xffffffffu) return -1; /* len+1 would wrap */
          len += 1;
          ip += extra;
        }
        if (len > n - ip || op > expect || len > expect - op) return -1;
        memcpy(dst + op, src + ip, len);
        ip += len;
        op += len;
        break;
      }
      case 1: {
        if (ip >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        offset = ((uint32_t)(tag >> 5) << 8) | src[ip++];
        goto copy;
      }
      case 2: {
        if (n - ip < 2) return -1;
        len = (tag >> 2) + 1;
        offset = (uint32_t)src[ip] | ((uint32_t)src[ip + 1] << 8);
        ip += 2;
        goto copy;
      }
      default: {
        if (n - ip < 4) return -1;
        len = (tag >> 2) + 1;
        offset = load32(src + ip);
        ip += 4;
      copy:
        if (offset == 0 || offset > op || op > expect || len > expect - op)
          return -1;
        /* byte-by-byte: overlapping copies are the run-length mechanism */
        for (uint32_t i = 0; i < len; i++) dst[op + i] = dst[op + i - offset];
        op += len;
        break;
      }
    }
  }
  return op == expect ? (int64_t)op : -1;
}

/* ------------------------------------------------------------- CRC32C */

static uint32_t crc32c_table[256];

/* runs at dlopen, before any Python thread can call in — no lazy-init
 * data race */
__attribute__((constructor)) static void crc32c_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[i] = c;
  }
}

uint32_t snappy_crc32c(const uint8_t* data, uint32_t n) {
  uint32_t c = 0xffffffffu;
  for (uint32_t i = 0; i < n; i++)
    c = crc32c_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}
