// The curve a translation unit is built for.  ops/kernels.py builds one
// library per curve from the curve-dependent sources: BN254a by default,
// BN254b with -DOZ_CURVE_BN254B.  A unit's kernels are the headers'
// templates instantiated for its curve's moduli; the entry points keep
// their names, each library is loaded on its own.  Field ids in the entry
// points: 0 = the curve's Fr, 1 = its Fq; group ids: 1 = G1, 2 = G2.
//
// With -DOZ_TEST_FIELDS a unit is built for the test fields, which belong
// to no curve (the field sources only): field 0 is SMALL, field 1 is
// LARGE, and there are no groups.
#pragma once
#include "fp2.cuh"

#if defined(OZ_TEST_FIELDS)
typedef SmallMod CurveFr;
typedef LargeMod CurveFq;
#else
#if defined(OZ_CURVE_BN254B)
typedef FrbMod CurveFr;
typedef FqbMod CurveFq;
#else
typedef FrMod CurveFr;
typedef FqMod CurveFq;
#endif

typedef Fp<CurveFq> G1Coord;
typedef Fp2<CurveFq> G2Coord;
#endif
