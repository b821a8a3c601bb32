/* Keccak-f[1600] permutation + STROBE-128 absorb/squeeze inner loops.
 *
 * The port's copy of native/keccak.c, the C core of the transcript (the
 * serial Fiat-Shamir spine).  transcript/strobe.py drives the protocol
 * framing; these entry points do the byte crunching.  transcript/_native.py
 * builds this file with gcc into a shared library at first use and loads it
 * through ctypes.
 */

#include <stdint.h>
#include <string.h>

#define ROL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

void keccak_f1600(uint8_t *state) {
  uint64_t A[25];
  memcpy(A, state, 200);
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t C[5], D[5], B[25];
    for (int x = 0; x < 5; x++)
      C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    for (int x = 0; x < 5; x++)
      D[x] = C[(x + 4) % 5] ^ ROL64(C[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) A[i] ^= D[i % 5];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int r = RHO[x][y];
        uint64_t v = A[x + 5 * y];
        B[y + 5 * ((2 * x + 3 * y) % 5)] = r ? ROL64(v, r) : v;
      }
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        A[x + 5 * y] =
            B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y]);
    A[0] ^= RC[rnd];
  }
  memcpy(state, A, 200);
}

/* STROBE-128 inner loops over a 200-byte state.  pos/pos_begin are
 * passed in a 2-int32 scratch; R = 166. */
#define STROBE_R 166

static void run_f(uint8_t *state, int32_t *pos) {
  state[pos[0]] ^= (uint8_t)pos[1];
  state[pos[0] + 1] ^= 0x04;
  state[STROBE_R + 1] ^= 0x80;
  keccak_f1600(state);
  pos[0] = 0;
  pos[1] = 0;
}

void strobe_absorb(uint8_t *state, int32_t *pos, const uint8_t *data,
                   int64_t len) {
  for (int64_t i = 0; i < len; i++) {
    state[pos[0]] ^= data[i];
    if (++pos[0] == STROBE_R) run_f(state, pos);
  }
}

void strobe_overwrite(uint8_t *state, int32_t *pos, const uint8_t *data,
                      int64_t len) {
  for (int64_t i = 0; i < len; i++) {
    state[pos[0]] = data[i];
    if (++pos[0] == STROBE_R) run_f(state, pos);
  }
}

void strobe_squeeze(uint8_t *state, int32_t *pos, uint8_t *out, int64_t len) {
  for (int64_t i = 0; i < len; i++) {
    out[i] = state[pos[0]];
    state[pos[0]] = 0;
    if (++pos[0] == STROBE_R) run_f(state, pos);
  }
}

void strobe_run_f(uint8_t *state, int32_t *pos) { run_f(state, pos); }
