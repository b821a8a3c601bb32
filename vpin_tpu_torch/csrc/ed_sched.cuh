// The stage schedule of one unified addition on ristretto255
// (add-2008-hwcd-3, a = -1), for the K5 group kernel (ed_ladder.cu).
//
// The table has the row format of e2_sched.cuh (E2Op: kind, destination
// slot, operand slots, stage, virtual lane) and runs on the same group
// runner (e2_run, e2.cuh), with the product mod p = 2^255 - 19 (fe_mul_p,
// ed.cuh); the rules of e2_sched.cuh hold: inside a stage no lane reads or
// writes a slot that another lane writes, and a row reads only values
// written in an earlier stage or earlier on its own lane
// (tests/test_torch_ed_sched.py checks them for G = 4 and 8, for one
// addition and for each mode of the ladder step).  Virtual lane v of the
// j-th addition of a mode runs on lane (v + j * width) % G, width being
// the stage's largest virtual lane + 1.
//
// The values are those of vpin_tpu/curve/pallas_edwards.py:_ed_add_rows and
// of ed.cuh's ed_add, in the same polynomials: every field operation returns
// the canonical residue, so any schedule of them gives the same limbs.  The
// formula itself is not free: extended coordinates are not unique, so the
// doubling stays the addition of base with itself.  9 products in three
// product stages, 4 + 1 + 4:
//   stage 0: 2d T2, A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2),
//            Dd = Z1 (Z2 + Z2)
//   stage 1: C = T1 (2d T2); E = B - A, H = B + A, F = Dd - C, G = Dd + C
//   stage 2: X3 = E F, Y3 = G H, T3 = E H, Z3 = F G
// The additions of a mode all take the same P2 (the ladder step's acc + base
// and base + base), so 2d T2, whose slot is shared, is formed once per mode,
// by the first addition's lane: the step's pair takes 7 + 2 + 8 products,
// 3 product rounds with G = 8 and 2 + 1 + 2 with G = 4.  The sums and
// differences of P2's coordinates are formed on each lane whose product
// needs them, into that addition's own working slots: a sum on a lane that
// runs anyway costs no round, where forming it once would cost a stage.
// vpin_tpu_torch/curve/e2_sched.py reads this file and lays the table out
// for the kernel.
//
// Slots: the inputs, the sum, 2d and 2d T2 are mapped by the caller; the
// working values of one addition share 8 slots P0..P7, each name below on
// the slot it occupies (a slot is reused once its value is dead).
#pragma once

#include "e2_sched.cuh"

enum EdSlot {
  ED_X1, ED_Y1, ED_Z1, ED_T1, ED_X2, ED_Y2, ED_Z2, ED_T2,  // P1 and P2
  ED_X3, ED_Y3, ED_Z3, ED_T3,                              // P1 + P2
  ED_D2, ED_DT2,                                           // 2d, Montgomery form; 2d T2
  ED_P0, ED_P1, ED_P2, ED_P3, ED_P4, ED_P5, ED_P6, ED_P7,
  ED_NSLOT,
  // stage 0: the differences, sums and products; A and B overwrite the
  // difference and the sum of P1's coordinates, Dd the sum Z2 + Z2
  ED_U1 = ED_P0, ED_U2 = ED_P1, ED_A = ED_P0,
  ED_V1 = ED_P2, ED_V2 = ED_P3, ED_B = ED_P2,
  ED_ZZ = ED_P4, ED_DD = ED_P4,
  // stage 1: E and H on the slots of the dead U2 and V2, then C, F, G
  ED_E = ED_P1, ED_H = ED_P3, ED_C = ED_P5, ED_F = ED_P6, ED_G = ED_P7,
};

#define ED_NSTAGE 3

// The program the kernel runs (EdProg, ed_ladder.cu), for up to E2_MAXG
// lanes: per mode and stage each lane's rows, at most ED_MAXOPS rows.
#define ED_MODES 4
#define ED_MAXOPS 96

// The element layout of the kernel, which e2_sched.py reads from here: acc
// and base, 2d, 2d T2, then an addition's 8 working slots from ED_EL_TEMP
// (the doubling's after the addition's), each slot E2_SLOT_WORDS words.
#define ED_NTEMP 8
#define ED_EL_D2 8
#define ED_EL_DT2 9
#define ED_EL_TEMP 10
// K5: a step's mode holds K5_MODE_ADD where acc takes acc + base (the bit
// is set) and K5_MODE_DBL where base takes base + base (a bit follows); the
// sums go straight to acc and base, which stage 2 alone writes and no row
// of stage 2 reads.
#define K5_ACC 0
#define K5_BASE 4
#define K5_MODE_ADD 1
#define K5_MODE_DBL 2

// In stage order, then virtual lane, then the order a lane runs its rows.
[[maybe_unused]] static const E2Op kEdSched[] = {
  // stage 0: 2d T2 (shared), A, B, Dd
  {E2_MUL, ED_DT2, ED_D2, ED_T2, 0, 0},
  {E2_SUB, ED_U1, ED_Y1, ED_X1, 0, 1},
  {E2_SUB, ED_U2, ED_Y2, ED_X2, 0, 1},
  {E2_MUL, ED_A, ED_U1, ED_U2, 0, 1},
  {E2_ADD, ED_V1, ED_Y1, ED_X1, 0, 2},
  {E2_ADD, ED_V2, ED_Y2, ED_X2, 0, 2},
  {E2_MUL, ED_B, ED_V1, ED_V2, 0, 2},
  {E2_ADD, ED_ZZ, ED_Z2, ED_Z2, 0, 3},
  {E2_MUL, ED_DD, ED_Z1, ED_ZZ, 0, 3},
  // stage 1: E, H; C = T1 (2d T2), then F and G on C's lane
  {E2_SUB, ED_E, ED_B, ED_A, 1, 0},
  {E2_ADD, ED_H, ED_B, ED_A, 1, 1},
  {E2_MUL, ED_C, ED_T1, ED_DT2, 1, 2},
  {E2_SUB, ED_F, ED_DD, ED_C, 1, 2},
  {E2_ADD, ED_G, ED_DD, ED_C, 1, 2},
  // stage 2: X3 = E F, Y3 = G H, T3 = E H, Z3 = F G
  {E2_MUL, ED_X3, ED_E, ED_F, 2, 0},
  {E2_MUL, ED_Y3, ED_G, ED_H, 2, 1},
  {E2_MUL, ED_T3, ED_E, ED_H, 2, 2},
  {E2_MUL, ED_Z3, ED_F, ED_G, 2, 3},
};
