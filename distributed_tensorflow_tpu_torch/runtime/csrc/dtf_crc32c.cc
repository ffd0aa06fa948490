// CRC32C (Castagnoli) of the port's host runtime: the checksum of the
// checkpoint manifests, the DiLoCo mailbox's posts and the tfevents
// records (runtime/native.py binds it through ctypes; a plain C ABI, no
// Python or PyTorch headers, built by the host C++ compiler).
//
// Three bodies, one value (tests hold them against each other and against
// the pure-Python table of utils/summary.py on every length 0-4096 at every
// alignment):
//   dtf_crc32c_bytewise: the table a byte, the reference definition;
//   dtf_crc32c_slice8:   slicing-by-8 over eight tables, 8 bytes a step;
//   dtf_crc32c_hw:       SSE4.2's crc32 instruction (x86-64), which
//                        computes this CRC's reflected polynomial itself.
// dtf_crc32c takes the instruction where the CPU has it, else slicing-by-8.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli polynomial

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k) crc = (crc & 1) ? (crc >> 1) ^ kPoly : crc >> 1;
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFFu];
  }
};

// Function-local static: thread-safe one-time init (ctypes drops the GIL,
// so a first use can race between threads).
const Tables& tables() {
  static const Tables tab;
  return tab;
}

uint32_t bytewise(uint32_t crc, const uint8_t* p, size_t n) {
  const uint32_t* t = tables().t[0];
  for (size_t i = 0; i < n; ++i) crc = t[(crc ^ p[i]) & 0xFFu] ^ (crc >> 8);
  return crc;
}

uint32_t slice8(uint32_t crc, const uint8_t* p, size_t n) {
  const Tables& tab = tables();
  // Byte steps up to an 8-byte boundary, then 8 bytes a step, then the tail.
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = tab.t[0][(crc ^ *p++) & 0xFFu] ^ (crc >> 8);
    --n;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);  // little-endian hosts (x86-64, aarch64)
    uint32_t lo = static_cast<uint32_t>(w) ^ crc;
    uint32_t hi = static_cast<uint32_t>(w >> 32);
    crc = tab.t[7][lo & 0xFF] ^ tab.t[6][(lo >> 8) & 0xFF] ^ tab.t[5][(lo >> 16) & 0xFF] ^
          tab.t[4][lo >> 24] ^ tab.t[3][hi & 0xFF] ^ tab.t[2][(hi >> 8) & 0xFF] ^
          tab.t[1][(hi >> 16) & 0xFF] ^ tab.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  return bytewise(crc, p, n);
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t hardware(uint32_t crc, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = __builtin_ia32_crc32qi(crc, *p++);
    --n;
  }
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c = __builtin_ia32_crc32di(c, w);
    p += 8;
    n -= 8;
  }
  crc = static_cast<uint32_t>(c);
  while (n--) crc = __builtin_ia32_crc32qi(crc, *p++);
  return crc;
}

bool have_hardware() {
  static const bool has = __builtin_cpu_supports("sse4.2");
  return has;
}
#else
uint32_t hardware(uint32_t crc, const uint8_t* p, size_t n) { return slice8(crc, p, n); }
bool have_hardware() { return false; }
#endif

}  // namespace

extern "C" {

uint32_t dtf_crc32c_bytewise(const uint8_t* data, size_t n) {
  return bytewise(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
}

uint32_t dtf_crc32c_slice8(const uint8_t* data, size_t n) {
  return slice8(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
}

// The instruction's body; 0xFFFFFFFF (no CRC) where the CPU lacks it, so a
// caller checks dtf_crc32c_hw_available first.
uint32_t dtf_crc32c_hw(const uint8_t* data, size_t n) {
  if (!have_hardware()) return 0xFFFFFFFFu;
  return hardware(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
}

int dtf_crc32c_hw_available(void) { return have_hardware() ? 1 : 0; }

uint32_t dtf_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = have_hardware() ? hardware(0xFFFFFFFFu, data, n) : slice8(0xFFFFFFFFu, data, n);
  return crc ^ 0xFFFFFFFFu;
}

// TFRecord's masked CRC: rotate right by 15, plus a constant.
uint32_t dtf_crc32c_masked(const uint8_t* data, size_t n) {
  uint32_t crc = dtf_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // extern "C"
