// K1 on lane groups: the rows of csrc/ladder.cu's kernel and the forms'
// schedules, generated by lighthouse_tpu_torch/ops/ladder_rows.py. Do not
// edit; regenerate with
//     python -m lighthouse_tpu_torch.ops.ladder_rows
// Table: [MUL index | LIN index | MUL rows | LIN rows | terms], u32
// words; an index word is first row | rows << 16, for each phase
// (D1, D3, A1, A3, then DBL_MID, DBL_OUT, ADD_MID, ADD_OUT) and thread;
// a MUL row is dst | a << 6 | a2 << 12 | b << 18 | b2 << 24, the Fp
// slots of values (component 0), writing (a + a2)(b + b2) (a2, b2 NONE:
// absent); a LIN row is
// dst | terms << 8 | first term << 16, writing sum_t c_t slot_t with a
// term slot | c << 12.
#pragma once

#include <stdint.h>

namespace k1rows {

constexpr int T = 2;  // threads a lane
constexpr int BLOCK = 64;  // threads a block
// the forms' points of scratch a lane and the window forms' doublings a window
constexpr int ENTRIES_WINDOW = 9;
constexpr int ENTRIES_W2 = 4;
constexpr int ENTRIES_CHAIN = 2;
constexpr int DOUBLINGS_WINDOW = 4;
constexpr int DOUBLINGS_W2 = 2;
constexpr int NONE = 63;  // an absent second term of a MUL operand
constexpr int MUL_INDEX = 0, LIN_INDEX = 8;

// G1: 12 Fp slots a lane, 76 table words
constexpr int SLOTS_G1 = 12;
constexpr int WORDS_G1 = 76;
__device__ const uint32_t TABLE_G1[76] = {
    0x00020010u, 0x00020012u, 0x00020014u, 0x00020016u, 0x00030018u, 0x0003001bu, 0x0003001eu, 0x00030021u,
    0x00010024u, 0x00010025u, 0x00020026u, 0x00010028u, 0x00030029u, 0x0002002cu, 0x0002002eu, 0x00010030u,
    0x3f07f046u, 0x3f0bf047u, 0x3f0bf088u, 0x3f07f009u, 0x3f27f0cau, 0x3f0bf0c4u, 0x3f23f18bu, 0x3f1bf1c5u,
    0x3f0ff006u, 0x040c1009u, 0x3f17f088u, 0x3f13f047u, 0x0510204au, 0x050c200bu, 0x3f0bf047u, 0x3f1bf089u,
    0x3f03f18bu, 0x3f13f008u, 0x3f0ff10au, 0x3f07f0c5u, 0x00310202u, 0x00330203u, 0x00350100u, 0x00360102u,
    0x00370201u, 0x00390300u, 0x003c0302u, 0x003f0204u, 0x00410301u, 0x00440203u, 0x00460200u, 0x00480202u,
    0x004a0201u, 0x00001006u, 0x0000c008u, 0x00001006u, 0xfffdc008u, 0x0000200au, 0x00008005u, 0x00001004u,
    0x0006000bu, 0xfffff006u, 0xfffff007u, 0x00001009u, 0xfffff006u, 0xfffff008u, 0x0000100bu, 0x00001007u,
    0xffff4008u, 0xfffff007u, 0xfffff008u, 0x0000100au, 0x00001007u, 0x0000c008u, 0xffff4007u, 0x00001008u,
    0x00001005u, 0x0000300bu, 0x00024009u, 0x0000100au,
};

// G2: 24 Fp slots a lane, 132 table words
constexpr int SLOTS_G2 = 24;
constexpr int WORDS_G2 = 132;
__device__ const uint32_t TABLE_G2[132] = {
    0x00020010u, 0x00020012u, 0x00020014u, 0x00020016u, 0x00030018u, 0x0003001bu, 0x0003001eu, 0x00030021u,
    0x00020024u, 0x00020026u, 0x00030028u, 0x0003002bu, 0x0005002eu, 0x00050033u, 0x00030038u, 0x0003003bu,
    0x3f0bf08cu, 0x3f13f08eu, 0x3f13f110u, 0x3f0bf012u, 0x3f4bf194u, 0x3f13f188u, 0x3f43f316u, 0x3f33f38au,
    0x3f1bf00cu, 0x08182012u, 0x3f2bf110u, 0x3f23f08eu, 0x0a204094u, 0x0a184016u, 0x3f13f08eu, 0x3f33f112u,
    0x3f03f316u, 0x3f23f010u, 0x3f1bf214u, 0x3f0bf18au, 0x003e0304u, 0x00410306u, 0x00440305u, 0x00470307u,
    0x004a0100u, 0x004b0302u, 0x004e0104u, 0x004f0101u, 0x00500303u, 0x00530105u, 0x00540300u, 0x00570302u,
    0x005a0304u, 0x005d0306u, 0x00600308u, 0x00630301u, 0x00660303u, 0x00690305u, 0x006c0307u, 0x006f0309u,
    0x00720300u, 0x00750302u, 0x00780204u, 0x007a0301u, 0x007d0303u, 0x00800205u, 0x0000100cu, 0x0000c010u,
    0xffff4011u, 0x0000100cu, 0xfffdc010u, 0x00024011u, 0x0000100du, 0x0000c010u, 0x0000c011u, 0x0000100du,
    0xfffdc010u, 0xfffdc011u, 0x00002014u, 0x00001008u, 0x00060016u, 0xfffa0017u, 0x0000800au, 0x00002015u,
    0x00001009u, 0x00060016u, 0x00060017u, 0x0000800bu, 0xfffff00cu, 0xfffff00eu, 0x00001012u, 0xfffff00eu,
    0xfffff010u, 0x00001014u, 0xfffff00cu, 0xfffff010u, 0x00001016u, 0x0000100eu, 0x0000c010u, 0xffff4011u,
    0x0000100eu, 0xffff4010u, 0x0000c011u, 0xfffff00du, 0xfffff00fu, 0x00001013u, 0xfffff00fu, 0xfffff011u,
    0x00001015u, 0xfffff00du, 0xfffff011u, 0x00001017u, 0x0000100fu, 0x0000c010u, 0x0000c011u, 0x0000100fu,
    0xffff4010u, 0xffff4011u, 0xffff400eu, 0x0000c00fu, 0x00001010u, 0x00024012u, 0xfffdc013u, 0x00001014u,
    0x0000100au, 0x00003016u, 0xffff400eu, 0xffff400fu, 0x00001011u, 0x00024012u, 0x00024013u, 0x00001015u,
    0x0000100bu, 0x00003017u, 0x00000000u, 0x00000000u,
};

}  // namespace k1rows
