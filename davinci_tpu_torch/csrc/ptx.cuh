// Hopper's carry-chained 32-bit integer instructions, one PTX instruction
// each: add.cc / addc, sub.cc / subc and the multiply-adds mad.lo.cc,
// madc.lo.cc, mad.hi.cc, madc.hi.cc that read and set the carry flag.  A
// chain is a run of these calls in program order: each is `asm volatile`,
// so the compiler keeps their order and drops none, and ptxas carries the
// flag from one to the next.  No other code may sit inside a chain (a
// chain ends with an instruction that does not set the flag, or its last
// carry is known to be zero).  Used by csrc/addk.cu only.

#pragma once

#include <cstdint>

namespace {

#define DAVINCI_CARRY2(name, op)                                   \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) { \
    uint32_t r;                                                    \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));    \
    return r;                                                      \
  }

#define DAVINCI_CARRY3(name, op)                                            \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,           \
                                           uint32_t c) {                     \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                               \
  }

DAVINCI_CARRY2(add_cc, "add.cc.u32")    // a + b, sets the carry
DAVINCI_CARRY2(addc_cc, "addc.cc.u32")  // a + b + carry, sets it
DAVINCI_CARRY2(addc, "addc.u32")        // a + b + carry
DAVINCI_CARRY2(sub_cc, "sub.cc.u32")    // a - b, sets the borrow
DAVINCI_CARRY2(subc_cc, "subc.cc.u32")  // a - b - borrow, sets it
DAVINCI_CARRY2(subc, "subc.u32")        // a - b - borrow
DAVINCI_CARRY3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a b) + c, sets the carry
DAVINCI_CARRY3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a b) + c + carry, sets it
DAVINCI_CARRY3(mad_hi_cc, "mad.hi.cc.u32")    // hi(a b) + c, sets the carry
DAVINCI_CARRY3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a b) + c + carry, sets it
DAVINCI_CARRY3(madc_hi, "madc.hi.u32")        // hi(a b) + c + carry

#undef DAVINCI_CARRY2
#undef DAVINCI_CARRY3

}  // namespace
