// The stage schedule of one complete addition on E2 (RCB15 Alg. 1, general
// a), for the group kernels of e2.cuh (K2, K3).
//
// Every field operation of the addition is one row: kind, destination slot,
// operand slots, stage and virtual lane.  A group of G lanes runs the
// stages in order with a __syncwarp between two stages; inside a stage each
// lane runs its own rows in table order, so a lane's adds feed its own
// product without a barrier.  Rules that keep the stages free of races
// (tests/test_torch_e2_sched.py checks them for G = 4 and 8, for one
// addition and for the ladder step's pair): inside a stage no lane reads or
// writes a slot that another lane writes, and a row reads only values
// written in an earlier stage or earlier on its own lane.  Virtual lane v
// runs on lane v % G; in a pair the second addition's lanes are shifted by
// the stage's width (its largest virtual lane + 1), so with G = 8 the pair
// takes 2 + 1 + 2 + 1 rounds of products and one addition 1 + 1 + 1 + 1.
// vpin_tpu_torch/curve/e2_sched.py reads this file and lays the table out
// for the kernels.
//
// The values are those of vpin_tpu/curve/pallas_ec.py:_ec_add_rows: every
// field operation returns the canonical residue, so any schedule of the
// same polynomials gives the same limbs.  Slots: the inputs and the sum are
// mapped by the caller; the working values share 13 slots P0..P12, each
// name below on the slot it occupies (a slot is reused once its value is
// dead in every lane).
#pragma once

#include <cstdint>

enum E2Slot {
  E2_X1, E2_Y1, E2_Z1, E2_X2, E2_Y2, E2_Z2,  // P1 and P2
  E2_X3, E2_Y3, E2_Z3,                       // P1 + P2
  E2_A, E2_B3,                               // a and 3b, Montgomery form
  E2_P0, E2_P1, E2_P2, E2_P3, E2_P4, E2_P5, E2_P6, E2_P7, E2_P8, E2_P9,
  E2_P10, E2_P11, E2_P12,
  E2_NSLOT,
  // stage 0: the sums of coordinates, then the six products
  E2_SA = E2_P0, E2_SB = E2_P1, E2_SC = E2_P2, E2_SD = E2_P3,
  E2_SE = E2_P4, E2_SF = E2_P5,
  E2_T0 = E2_P6, E2_T1 = E2_P7, E2_T2 = E2_P8,
  E2_PXY = E2_P0, E2_PXZ = E2_P2, E2_PYZ = E2_P4,
  // stage 1: t3 = X1Y2 + X2Y1, t4 = X1Z2 + X2Z1, t5 = Y1Z2 + Y2Z1, 3 t0
  E2_U3 = E2_P1, E2_T3 = E2_P0, E2_U4 = E2_P3, E2_T4 = E2_P2,
  E2_U5 = E2_P5, E2_T5 = E2_P4, E2_M2 = E2_P12, E2_M3 = E2_P12,
  // stage 2: the products by the constants
  E2_AT4 = E2_P1, E2_B3T2 = E2_P3, E2_AT2 = E2_P5, E2_B3T4 = E2_P9,
  // stage 3: W = b3 t2 + a t4 (on two lanes), U, V, M, D = t0 - a t2
  E2_W = E2_P10, E2_U = E2_P10, E2_W2 = E2_P11, E2_V = E2_P11,
  E2_M = E2_P12, E2_D = E2_P2,
  // stage 4: U V, a D, U t3, t5 V, t3 M
  E2_Y3A = E2_P1, E2_AD = E2_P3, E2_UT3 = E2_P5, E2_T5V = E2_P6,
  E2_T3M = E2_P7,
  // stage 5: S = b3 t4 + a D (on two lanes), M S, t5 S
  E2_S = E2_P8, E2_MS = E2_P8, E2_S2 = E2_P10, E2_T5S = E2_P10,
};

enum E2Kind { E2_MUL, E2_ADD, E2_SUB };

struct E2Op {
  uint8_t kind, dst, a, b, stage, lane;
};

#define E2_NSTAGE 7

// The program the kernels run (E2Prog, e2.cuh), which
// vpin_tpu_torch/curve/e2_sched.py lays out from this table: per mode and
// stage each lane's rows, for up to E2_MAXG lanes and E2_MAXOPS rows.
#define E2_MODES 4
#define E2_MAXG 8
#define E2_MAXOPS 192

// The element layouts of the kernels, which e2_sched.py reads from here.
// An element's slots lie E2_SLOT_WORDS words apart in shared memory: 8
// limbs padded to 48 bytes, so the 16-byte halves of 8 slots that differ
// mod 8 fall in 8 different groups of 4 banks (an unpadded 32-byte slot
// reaches only every other group).  Every element holds a and 3b, then an
// addition's 13 working slots from E2_EL_TEMP (a pair's second addition's
// after the first's).
#define E2_SLOT_WORDS 12
#define E2_NTEMP 13
#define E2_EL_A 6
#define E2_EL_B3 7
#define E2_EL_TEMP 8
// K2 (e2_add.cu): P and Q; P + Q overwrites P, which only stage 0 reads.
// Mode 1 adds, mode 0 (past the end of the batch) does nothing.
#define K2_P 0
#define K2_Q 3
// K3 (e2_scalar_mul.cu): acc and base.  A step's mode holds
// K3_MODE_ADD where acc takes acc + base (the bit is set) and K3_MODE_DBL
// where base takes base + base (a bit follows); the sums go straight to
// acc and base, which both additions read only in stage 0.
#define K3_ACC 0
#define K3_BASE 3
#define K3_MODE_ADD 1
#define K3_MODE_DBL 2

// In stage order, then virtual lane, then the order a lane runs its rows.
[[maybe_unused]] static const E2Op kE2Sched[] = {
  // stage 0: t0, t1, t2 and the three products of sums
  {E2_MUL, E2_T0, E2_X1, E2_X2, 0, 0},
  {E2_MUL, E2_T1, E2_Y1, E2_Y2, 0, 1},
  {E2_MUL, E2_T2, E2_Z1, E2_Z2, 0, 2},
  {E2_ADD, E2_SA, E2_X1, E2_Y1, 0, 3},
  {E2_ADD, E2_SB, E2_X2, E2_Y2, 0, 3},
  {E2_MUL, E2_PXY, E2_SA, E2_SB, 0, 3},
  {E2_ADD, E2_SC, E2_X1, E2_Z1, 0, 4},
  {E2_ADD, E2_SD, E2_X2, E2_Z2, 0, 4},
  {E2_MUL, E2_PXZ, E2_SC, E2_SD, 0, 4},
  {E2_ADD, E2_SE, E2_Y1, E2_Z1, 0, 5},
  {E2_ADD, E2_SF, E2_Y2, E2_Z2, 0, 5},
  {E2_MUL, E2_PYZ, E2_SE, E2_SF, 0, 5},
  // stage 1: t3, t4, t5 and 3 t0
  {E2_ADD, E2_U3, E2_T0, E2_T1, 1, 0},
  {E2_SUB, E2_T3, E2_PXY, E2_U3, 1, 0},
  {E2_ADD, E2_U4, E2_T0, E2_T2, 1, 1},
  {E2_SUB, E2_T4, E2_PXZ, E2_U4, 1, 1},
  {E2_ADD, E2_U5, E2_T1, E2_T2, 1, 2},
  {E2_SUB, E2_T5, E2_PYZ, E2_U5, 1, 2},
  {E2_ADD, E2_M2, E2_T0, E2_T0, 1, 3},
  {E2_ADD, E2_M3, E2_M2, E2_T0, 1, 3},
  // stage 2: a t4, 3b t2, a t2, 3b t4
  {E2_MUL, E2_AT4, E2_A, E2_T4, 2, 0},
  {E2_MUL, E2_B3T2, E2_B3, E2_T2, 2, 1},
  {E2_MUL, E2_AT2, E2_A, E2_T2, 2, 2},
  {E2_MUL, E2_B3T4, E2_B3, E2_T4, 2, 3},
  // stage 3: U = t1 - W, V = t1 + W, M = 3 t0 + a t2, D = t0 - a t2
  {E2_ADD, E2_W, E2_B3T2, E2_AT4, 3, 0},
  {E2_SUB, E2_U, E2_T1, E2_W, 3, 0},
  {E2_ADD, E2_W2, E2_B3T2, E2_AT4, 3, 1},
  {E2_ADD, E2_V, E2_T1, E2_W2, 3, 1},
  {E2_ADD, E2_M, E2_M3, E2_AT2, 3, 2},
  {E2_SUB, E2_D, E2_T0, E2_AT2, 3, 3},
  // stage 4: U V, a D, U t3, t5 V, t3 M
  {E2_MUL, E2_Y3A, E2_U, E2_V, 4, 0},
  {E2_MUL, E2_AD, E2_A, E2_D, 4, 1},
  {E2_MUL, E2_UT3, E2_U, E2_T3, 4, 2},
  {E2_MUL, E2_T5V, E2_T5, E2_V, 4, 3},
  {E2_MUL, E2_T3M, E2_T3, E2_M, 4, 4},
  // stage 5: S = 3b t4 + a D, then M S and t5 S
  {E2_ADD, E2_S, E2_B3T4, E2_AD, 5, 0},
  {E2_MUL, E2_MS, E2_M, E2_S, 5, 0},
  {E2_ADD, E2_S2, E2_B3T4, E2_AD, 5, 1},
  {E2_MUL, E2_T5S, E2_T5, E2_S2, 5, 1},
  // stage 6: X3 = U t3 - t5 S, Y3 = U V + M S, Z3 = t5 V + t3 M
  {E2_SUB, E2_X3, E2_UT3, E2_T5S, 6, 0},
  {E2_ADD, E2_Y3, E2_Y3A, E2_MS, 6, 1},
  {E2_ADD, E2_Z3, E2_T5V, E2_T3M, 6, 2},
};
