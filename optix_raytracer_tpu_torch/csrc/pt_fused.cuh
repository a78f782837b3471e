// The fused path-trace kernel: a whole progressive launch per pixel.
//
// Replaces wavefront/pallas_pt.py::render_sum_fused -> _make_kernel/kernel
// (kernel 3) and its static variants (3'): a template over <kGeom,
// kSpecular, kPbr, kPrims>. kGeom is the geometry mode: kFlat, kInst (the
// TPU kernel's inst_ranges: the shared triangles seen through at most 32
// instances), kSmooth (its smooth=True: interpolated vertex normals) or kTex
// (its tex_cfg: the in-kernel texture unit, fetch_bundle16 and the maps,
// pallas_pt.py:701-813, 1017-1079, on kSmooth's interpolation); the flags
// are its has_specular (glass and mirror lanes), has_pbr (rough
// metallic-roughness GGX lanes) and prim_kinds (inline sphere, shell,
// parallelogram and capsule intersectors). <kFlat, false, false, false> is
// the Cornell configuration. Instances meet neither smooth normals nor
// textures (pallas_pt.py:1430-1432). Each geometry mode's eight
// instantiations are compiled in a source of their own (pt_fused.cu,
// pt_fused_inst.cu, pt_fused_smooth.cu, pt_fused_tex.cu), so the per-source
// parallel build keeps its time.
// Per pixel, spl times: TEA seed, jittered raygen with the ortho and
// thin-lens selects, then up to max_depth bounces of closest hit
// (triangles, then prims), miss / emission, the material lanes, NEE toward
// the parallelogram light with an any-hit shadow ray (diffuse and PBR lanes;
// the full BRDF on PBR lanes), the next direction (cosine lobe, the
// one-sample-MIS cosine + GGX mixture on PBR lanes, mirror reflection,
// Fresnel-chosen glass reflect / refract) and Russian roulette. Outputs the
// radiance sum [H, W, 3] f32 and the rays traced per pixel [H*W] as int32
// (the TPU kernel's f32 count is inexact past 2^24; the wrapper sums these
// in int64).
//
// What bounds it on the H100: FP32 issue and divergence. A bounce tests
// every triangle and prim twice (closest, then shadow) at ~20-60 flops each;
// the scene (at most 512 triangles + 128 materials + 16 prims + 32
// instances, 44 KB) lives in shared memory and every read is a broadcast;
// HBM sees 16 bytes per pixel out. Paths end at different depths and glass,
// PBR and diffuse lanes of one warp take different branches, so warps lose
// lanes.
//
// Design: one thread per pixel, the path state in registers, a per-thread
// loop of spl samples x max_depth bounces. A path that misses or loses
// Russian roulette leaves the bounce loop; that gives the values of both
// the lock-step and the regeneration schedules of the TPU kernel, whose
// dead lanes add nothing. The shadow test is skipped when the light faces
// away or the lane is specular (its weight is zero either way) and stops at
// the first occluder. A prim's kind is a column of its row (the TPU kernel
// unrolls a static tuple); every thread reads the same row, so the switch
// on it never diverges.
//
// Instances (kInst): per instance, the ray moves into object space by the
// instance's world -> object 3x4 inverse (shared memory, row-major, sbt
// offset in column 12); the direction stays unnormalised, so object-space t
// is world t and the running minimum bt carries over from instance to
// instance. Each tests its triangle range [lo, hi) of the shared table; the
// winner records its instance, adds the instance's sbt offset to its
// material id (as integers), and its object-space face normal goes back to
// world by the row rule w_k = sum_j n_j inv[j][k], divided by its length.
// The shadow ray goes through each instance alike, its world-space [tmin,
// tmax) window unchanged.
//
// Smooth normals (kSmooth): for a triangle winner, its three corner normals
// (an [M, 9] plane in global memory) are read once, through the read-only
// path, and interpolated with the winning test's barycentrics, w n0 + u n1 +
// v n2 with w = (1 - u) - v, divided by the length, or the face normal
// where the length is 1e-6 or less (the engine's shading_frame). One
// indexed 36-byte load replaces the TPU kernel's unrolled selects (up to 64
// triangles) and its one-hot MXU contraction (up to 512): the plane is read
// for the winner only, 17 KB at 482 triangles stays in L1 / L2, and keeping
// it out of shared memory keeps the block under the 48 KB it gets without
// opting in (512 rows of 9 floats would add 18 KB to the 44 KB).
//
// Textures (kTex): the XLA engine shades every triangle hit of a textured
// scene through its shading frame, flat meshes included (engine.py:
// 320-333), so kTex interpolates the corner normals as kSmooth does (a flat
// mesh hands in its replicated face normals, which round apart from the
// face normal). The winner's 80-byte row of an [M, 20] plane (corner
// normals, corner uvs, tangent, uv density) is read once. A triangle hit on
// a material with a bundle (material row column 13; column 14 its map flags
// and chain length, column 15 its level-0 size) fetches 12 of the bundle's
// 16 channels trilinearly, in f32 (the engine's sample_bundle, the TPU
// kernel's ORT_TEX_F32=1; the bf16 one-hot MXU contraction is a TPU device):
// the mip level from the ray cone, log2(max(spread x (path length + t) x uv
// density x size, 1)) clipped to the chain (the spread in camera row 1 col
// 5), then per level the base texel wrapped into the level and four taps of
// one 64-byte texel row each, read through the read-only path from the
// [B, H', W', 16] atlas in device memory (6.5 MB for the bench's bundle:
// it stays in L2; the levels' one wrapped border row and column hold the
// far taps). The maps scale albedo, emission, roughness and metallic and
// bend the normal in the tangent frame before the material lanes read them,
// so a metallic-roughness map can make mirror lanes (kSpecular is on for
// such a scene). The fetch adds no shared memory: the block stays at the
// 44 KB of the caps.
//
// RNG: the draws follow the engine's order exactly: jitter, lens pair, then
// per bounce NEE, bounce direction, with kPbr two GGX pairs (drawn on every
// lane of a PBR scene, whatever its material), the glass pair (skipped with
// advance2 without kSpecular), Russian roulette.
//
// Arithmetic: the kernel computes what the port's wavefront engine computes
// (wavefront/engine.py, accel/primitives.py), operation for operation and
// in its order, so that with -fmad=false the two round alike and agree bit
// for bit, not only within the parity bars: normalisation is x * (1 /
// sqrt(max(x.x, 1e-20))), divisions stay divisions where the TPU kernel
// multiplies by a reciprocal (but the BRDF and pdf scale by the f32 1/pi,
// as engine.INV_PI does), the NEE terms are (T*albedo*Le)*w and
// ((T*f)*Le)*w2, x^5 is x*(x^2*x^2). Where the TPU kernel and the engine
// differ, it follows the engine: prims take the engine's candidate
// formulas (a capsule's nearest cap crossing is range-checked after the
// minimum over its caps, as accel/primitives.py does; the TPU kernel checks
// each crossing), the glass refraction uses the unclamped cos_i of
// vecmath.refract (the TPU kernel clamps it, pallas_pt.py:1242), and the
// smooth normal takes shading_frame's form and 1e-6 length test (the TPU
// kernel's is n0 + u (n1 - n0) + v (n2 - n0) with len^2 > 1e-12 and an
// rsqrt, pallas_pt.py:1006-1016). The instance transforms are the port's
// core/transforms.py products and sums, in their order. The texture unit
// follows shade/texture.py and engine._texture_lanes in their order (log2f
// and floorf, as PyTorch's CUDA log2 and floor call them; the normal map's
// tangent divided by max(|t|, 1e-8), not the TPU kernel's
// sqrt(max(., 1e-20)) form, pallas_pt.py:1064-1078).
#pragma once

#include "common.cuh"

namespace ort_fused {

// A launch's arguments, as ort_pt_fused takes them.
struct FusedArgs {
  const float* tri; int m;
  const float* prims; int np;
  const float* mats; int k;
  const float* light;
  const float* cam;
  const long long* subframe;
  int width, height, full_w, full_h, y0, spl, max_depth;
  float* rad;
  int* count;
  const float* inst;
  const int* inst_rng;
  int ni;
  const float* corner;
  const float* bundles;
  const int* bundle_mip;
  int n_levels, atlas_h, atlas_w;
  cudaStream_t stream;
};

// Each launches its geometry mode's instantiation <specular, pbr, prims>:
// pt_fused.cu, pt_fused_inst.cu and pt_fused_smooth.cu define one each.
void launch_flat(const FusedArgs& a, bool specular, bool pbr, bool prims);
void launch_inst(const FusedArgs& a, bool specular, bool pbr, bool prims);
void launch_smooth(const FusedArgs& a, bool specular, bool pbr, bool prims);
void launch_tex(const FusedArgs& a, bool specular, bool pbr, bool prims);

namespace {

// Geometry modes (kernels.GEOMETRY).
constexpr int kFlat = 0, kInst = 1, kSmooth = 2, kTex = 3;
constexpr int kTexAttrCols = 20;            // pallas_pt.TEX_ATTR_COLS
// pallas_pt.TEX_BASE / TEX_NORMAL / TEX_MR / TEX_EMISSIVE, TEX_CHAIN_SHIFT
constexpr int kTexBase = 1, kTexNormal = 2, kTexMr = 4, kTexEmissive = 8;
constexpr int kTexChainShift = 4;

constexpr int kThreads = 128;
constexpr float kRayTmin = 1e-2f;           // engine.RAY_TMIN
constexpr float kShadowTmaxScale = 0.999f;  // engine.SHADOW_TMAX_SCALE
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;   // engine.INV_PI
constexpr float kBig = 1e30f;               // primitives._BIG: no crossing
constexpr float kGlass = 2.0f, kPbrKind = 1.0f;   // shade.materials tags

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv = 1.0f / sqrtf(fmaxf(dot3(a, a), 1e-20f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

// o + t * d, the engine's Rays.at.
__device__ __forceinline__ V3 at3(V3 o, float t, V3 d) {
  return {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}

// Row i of a 3x4 row-major transform applied to v, as core/transforms.py
// _rows: (m0 * x + m1 * y) + m2 * z.
__device__ __forceinline__ float xf_row(const float* m, int i, V3 v) {
  return (m[4 * i] * v.x + m[4 * i + 1] * v.y) + m[4 * i + 2] * v.z;
}

// transforms.apply_point / apply_vector.
__device__ __forceinline__ V3 xf_point(const float* m, V3 p) {
  return {xf_row(m, 0, p) + m[3], xf_row(m, 1, p) + m[7],
          xf_row(m, 2, p) + m[11]};
}

__device__ __forceinline__ V3 xf_vector(const float* m, V3 v) {
  return {xf_row(m, 0, v), xf_row(m, 1, v), xf_row(m, 2, v)};
}

// tlas.unit_world_normal: w_k = (n.x inv[0][k] + n.y inv[1][k]) +
// n.z inv[2][k], divided by max(|w|, 1e-12).
__device__ __forceinline__ V3 unit_world_normal(const float* inv, V3 n) {
  const V3 w = {(n.x * inv[0] + n.y * inv[4]) + n.z * inv[8],
                (n.x * inv[1] + n.y * inv[5]) + n.z * inv[9],
                (n.x * inv[2] + n.y * inv[6]) + n.z * inv[10]};
  const float len = fmaxf(sqrtf(dot3(w, w)), 1e-12f);
  return {w.x / len, w.y / len, w.z / len};
}

// geometry.shading_frame's shading normal from one [9] corner-normal row
// (n0, n1, n2) and the hit's barycentrics; `face` where it degenerates.
__device__ __forceinline__ V3 smooth_normal(const float* __restrict__ cn,
                                            float u, float v, V3 face) {
  float c[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) c[j] = __ldg(cn + j);
  const float w = (1.0f - u) - v;
  const V3 sn = {(w * c[0] + u * c[3]) + v * c[6],
                 (w * c[1] + u * c[4]) + v * c[7],
                 (w * c[2] + u * c[5]) + v * c[8]};
  const float len = sqrtf(dot3(sn, sn));
  if (!(len > 1e-6f)) return face;
  const float l = fmaxf(len, 1e-12f);
  return {sn.x / l, sn.y / l, sn.z / l};
}

// One mip level of texture.sample_bundle: channels 0-11 of the bilinear
// fetch at wrapped uv (u, v) in [0, 1] from level `lv` of bundle `b`.
__device__ __forceinline__ void bundle_level(
    const float* __restrict__ bundles, const int* __restrict__ mip,
    int n_levels, int rows, int cols, int b, int lv, float u, float v,
    float out[12]) {
  const int* e = mip + 4 * (b * n_levels + lv);
  const float y_off = static_cast<float>(__ldg(e));
  const float x_off = static_cast<float>(__ldg(e + 1));
  const float h = fmaxf(static_cast<float>(__ldg(e + 2)), 1.0f);
  const float w = fmaxf(static_cast<float>(__ldg(e + 3)), 1.0f);
  const float x = u * w - 0.5f;
  const float y = v * h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int wi = static_cast<int>(w), hi = static_cast<int>(h);
  // the base corner wraps (x0 mod w, the sign of w); the border holds the
  // far taps
  const int xi = min(max(((static_cast<int>(x0) % wi) + wi) % wi +
                             static_cast<int>(x_off), 0), cols - 2);
  const int yi = min(max(((static_cast<int>(y0) % hi) + hi) % hi +
                             static_cast<int>(y_off), 0), rows - 2);
  const float4* r0 = reinterpret_cast<const float4*>(
      bundles + ((static_cast<size_t>(b) * rows + yi) * cols + xi) * 16);
  const float4* r1 = r0 + static_cast<size_t>(cols) * 4;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 c00 = __ldg(r0 + q), c01 = __ldg(r0 + 4 + q);
    const float4 c10 = __ldg(r1 + q), c11 = __ldg(r1 + 4 + q);
    out[4 * q] = (c00.x * gx + c01.x * fx) * gy + (c10.x * gx + c11.x * fx) * fy;
    out[4 * q + 1] = (c00.y * gx + c01.y * fx) * gy + (c10.y * gx + c11.y * fx) * fy;
    out[4 * q + 2] = (c00.z * gx + c01.z * fx) * gy + (c10.z * gx + c11.z * fx) * fy;
    out[4 * q + 3] = (c00.w * gx + c01.w * fx) * gy + (c10.w * gx + c11.w * fx) * fy;
  }
}

// texture.sample_bundle's trilinear fetch of channels 0-11 for one hit on
// bundle b: texel_scale the ray cone's footprint in uv units, dim0 / chain
// the bundle's level-0 size and mip count.
__device__ __forceinline__ void sample_bundle(
    const float* __restrict__ bundles, const int* __restrict__ mip,
    int n_levels, int rows, int cols, int b, float dim0, int chain,
    float uvx, float uvy, float texel_scale, float out[12]) {
  float lod = 0.0f;
  if (n_levels != 1) lod = log2f(fmaxf(texel_scale * dim0, 1.0f));
  lod = fminf(fmaxf(lod, 0.0f), static_cast<float>(chain) - 1.0f);
  const float fl = floorf(lod);
  const int l0 = static_cast<int>(fl);
  const int l1 = min(l0 + 1, chain - 1);
  const float f = lod - static_cast<float>(l0);
  const float u = uvx - floorf(uvx);
  const float v = uvy - floorf(uvy);
  float c1[12];
  bundle_level(bundles, mip, n_levels, rows, cols, b, l0, u, v, out);
  bundle_level(bundles, mip, n_levels, rows, cols, b, l1, u, v, c1);
  const float g = 1.0f - f;
#pragma unroll
  for (int j = 0; j < 12; ++j) out[j] = g * out[j] + f * c1[j];
}

// i - (2 * dot(i, n)) * n, vecmath.reflect.
__device__ __forceinline__ V3 reflect3(V3 i, V3 n) {
  const float dn = dot3(i, n);
  return {i.x - 2.0f * dn * n.x, i.y - 2.0f * dn * n.y, i.z - 2.0f * dn * n.z};
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// vecmath.orthonormal_basis: branchless Frisvad/Duff (tangent, bitangent).
__device__ __forceinline__ void basis(V3 n, V3& t, V3& bt) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  bt = {b, sign + n.y * n.y * a, -n.y};
}

// pallas_pt.py::_cosine_sample: concentric disk + Frisvad/Duff basis.
__device__ __forceinline__ V3 cosine_sample(float u1, float u2, V3 n) {
  const float ox = 2.0f * u1 - 1.0f;
  const float oy = 2.0f * u2 - 1.0f;
  const bool x_major = fabsf(ox) > fabsf(oy);
  float r = x_major ? ox : oy;
  const float safe_ox = ox == 0.0f ? 1.0f : ox;
  const float safe_oy = oy == 0.0f ? 1.0f : oy;
  const float quarter_pi = 0.7853981633974483f;
  const float half_pi = 1.5707963267948966f;
  const float theta = x_major ? quarter_pi * (oy / safe_ox)
                              : half_pi - quarter_pi * (ox / safe_oy);
  if (ox == 0.0f && oy == 0.0f) r = 0.0f;
  const float dx = r * cosf(theta);
  const float dy = r * sinf(theta);
  const float dz = sqrtf(fmaxf(0.0f, 1.0f - dx * dx - dy * dy));
  V3 t, bt;
  basis(n, t, bt);
  return normalize3({dx * t.x + dy * bt.x + dz * n.x,
                     dx * t.y + dy * bt.y + dz * n.y,
                     dx * t.z + dy * bt.z + dz * n.z});
}

// sampling.ggx_sample_half_vector (roughness already clamped to >= 0.05).
__device__ __forceinline__ V3 ggx_half(float u1, float u2, V3 n, float rough) {
  const float a2 = rough * rough;
  const float cos2 = (1.0f - u1) / fmaxf(u1 * (a2 * a2 - 1.0f) + 1.0f, 1e-12f);
  const float cos_t = sqrtf(fminf(fmaxf(cos2, 0.0f), 1.0f));
  const float sin_t = sqrtf(fmaxf(1.0f - cos2, 0.0f));
  const float phi = kTwoPi * u2;
  const float sc = sin_t * cosf(phi);
  const float ss = sin_t * sinf(phi);
  V3 t, bt;
  basis(n, t, bt);
  return normalize3({sc * t.x + ss * bt.x + cos_t * n.x,
                     sc * t.y + ss * bt.y + cos_t * n.y,
                     sc * t.z + ss * bt.z + cos_t * n.z});
}

// The GGX terms shared by engine._pbr_brdf and engine._pbr_pdf.
__device__ __forceinline__ float ggx_d(float n_dh, float rc) {
  const float a = rc * rc;
  const float a2 = a * a;
  const float denom = n_dh * n_dh * (a2 - 1.0f) + 1.0f;
  return a2 / fmaxf(kPi * denom * denom, 1e-8f);
}

// engine._pbr_brdf: lambert * (1 - metal) + Smith-Schlick GGX with Schlick
// Fresnel, f0 = lerp(0.04, albedo, metal).
__device__ __forceinline__ V3 pbr_brdf(V3 n, V3 wo, V3 wi, V3 alb, float metal,
                                       float rough) {
  const V3 h = normalize3({wo.x + wi.x, wo.y + wi.y, wo.z + wi.z});
  const float n_dl = fmaxf(dot3(n, wi), 0.0f);
  const float n_dv = fmaxf(dot3(n, wo), 1e-4f);
  const float n_dh = fmaxf(dot3(n, h), 0.0f);
  const float h_dv = fmaxf(dot3(h, wo), 0.0f);
  const float rc = fmaxf(rough, 0.05f);
  const float d_term = ggx_d(n_dh, rc);
  const float k = (rc + 1.0f) * (rc + 1.0f) / 8.0f;
  const float g = (n_dv / (n_dv * (1.0f - k) + k)) *
                  (n_dl / fmaxf(n_dl * (1.0f - k) + k, 1e-8f));
  const float x5 = pow5(1.0f - h_dv);
  const float spec = d_term * g / fmaxf(4.0f * n_dv * n_dl, 1e-8f);
  if (!(n_dl > 0.0f)) return {0.0f, 0.0f, 0.0f};
  const float f0k = 0.04f * (1.0f - metal);
  const float f0r = f0k + metal * alb.x;
  const float f0g = f0k + metal * alb.y;
  const float f0b = f0k + metal * alb.z;
  return {alb.x * (1.0f - metal) * kInvPi + (f0r + (1.0f - f0r) * x5) * spec,
          alb.y * (1.0f - metal) * kInvPi + (f0g + (1.0f - f0g) * x5) * spec,
          alb.z * (1.0f - metal) * kInvPi + (f0b + (1.0f - f0b) * x5) * spec};
}

// engine._pbr_pdf: the cosine + GGX one-sample-MIS mixture.
__device__ __forceinline__ float pbr_pdf(V3 n, V3 wo, V3 wi, float rough,
                                         float p_spec) {
  const V3 h = normalize3({wo.x + wi.x, wo.y + wi.y, wo.z + wi.z});
  const float n_dl = fmaxf(dot3(n, wi), 0.0f);
  const float n_dh = fmaxf(dot3(n, h), 0.0f);
  const float h_dv = fmaxf(dot3(h, wo), 1e-6f);
  const float rc = fmaxf(rough, 0.05f);
  const float pdf_ggx = ggx_d(n_dh, rc) * n_dh / fmaxf(4.0f * h_dv, 1e-8f);
  const float pdf_cos = n_dl * kInvPi;
  return p_spec * pdf_ggx + (1.0f - p_spec) * pdf_cos;
}

// ---- custom prims (accel/primitives.py::_prim_candidates, kinds 0-3) ----
// A prim row: params[0:12], mat_id (col 12), kind (col 13).

// The nearer of `best` and t when tmin < t < tmax (primitives.pick).
__device__ __forceinline__ float pick(float best, float t, float tmin,
                                      float tmax) {
  return (t > tmin && t < tmax) ? fminf(best, t) : best;
}

// Both sphere crossings; misses give kBig (primitives._sphere_ts).
__device__ __forceinline__ void sphere_ts(V3 o, V3 d, V3 c, float r, float& t0,
                                          float& t1) {
  const V3 oc = sub3(o, c);
  const float b = dot3(oc, d);
  const float cc = dot3(oc, oc) - r * r;
  const float disc = b * b - cc;
  const bool ok = disc > 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  t0 = ok ? -b - sq : kBig;
  t1 = ok ? -b + sq : kBig;
}

__device__ __forceinline__ V3 para_normal(const float* pr) {
  const V3 v1 = {pr[3], pr[4], pr[5]};
  const V3 v2 = {pr[6], pr[7], pr[8]};
  const V3 c = {v1.y * v2.z - v1.z * v2.y, v1.z * v2.x - v1.x * v2.z,
                v1.x * v2.y - v1.y * v2.x};
  const float len = fmaxf(sqrtf(dot3(c, c)), 1e-20f);
  return {c.x / len, c.y / len, c.z / len};
}

// The prim's nearest crossing in (tmin, tmax), or kBig.
__device__ float prim_t(const float* pr, V3 o, V3 d, float tmin, float tmax) {
  const int kind = static_cast<int>(pr[13]);
  const V3 c = {pr[0], pr[1], pr[2]};
  float t0, t1, best = kBig;
  if (kind == 0 || kind == 1) {              // sphere; shell adds its outer
    sphere_ts(o, d, c, pr[3], t0, t1);
    best = pick(pick(best, t0, tmin, tmax), t1, tmin, tmax);
    if (kind == 1) {
      sphere_ts(o, d, c, pr[4], t0, t1);
      best = pick(pick(best, t0, tmin, tmax), t1, tmin, tmax);
    }
    return best;
  }
  if (kind == 2) {                           // parallelogram
    const V3 v1 = {pr[3], pr[4], pr[5]};
    const V3 v2 = {pr[6], pr[7], pr[8]};
    const V3 n = para_normal(pr);
    const float denom = dot3(n, d);
    const float safe = fabsf(denom) < 1e-12f ? 1e-12f : denom;
    const float t = dot3(sub3(c, o), n) / safe;
    const V3 rel = sub3(at3(o, t, d), c);
    const float a1 = dot3(rel, v1) / fmaxf(dot3(v1, v1), 1e-20f);
    const float a2 = dot3(rel, v2) / fmaxf(dot3(v2, v2), 1e-20f);
    const bool ok = fabsf(denom) >= 1e-12f && a1 >= 0.0f && a1 <= 1.0f &&
                    a2 >= 0.0f && a2 <= 1.0f;
    return pick(best, ok ? t : kBig, tmin, tmax);
  }
  // capsule: the body, then the end caps on their outward halves
  const V3 pb = {pr[3], pr[4], pr[5]};
  const float r = pr[6];
  const V3 ba = sub3(pb, c);
  const V3 oa = sub3(o, c);
  const float baba = fmaxf(dot3(ba, ba), 1e-12f);
  const float bard = dot3(ba, d);
  const float baoa = dot3(ba, oa);
  const float rdoa = dot3(d, oa);
  const float oaoa = dot3(oa, oa);
  const float a_c = baba - bard * bard;
  const float b_c = baba * rdoa - baoa * bard;
  const float c_c = baba * oaoa - baoa * baoa - r * r * baba;
  const float h_c = b_c * b_c - a_c * c_c;
  const float safe_a = fabsf(a_c) < 1e-12f ? 1e-12f : a_c;
  float t_body = (-b_c - sqrtf(fmaxf(h_c, 0.0f))) / safe_a;
  const float y_c = baoa + t_body * bard;
  if (!(h_c > 0.0f && y_c > 0.0f && y_c < baba)) t_body = kBig;
  float t_cap = kBig;
  for (int e = 0; e < 2; ++e) {
    sphere_ts(o, d, e == 0 ? c : pb, r, t0, t1);
    const float tcs[2] = {t0, t1};
    for (int j = 0; j < 2; ++j) {
      const float yy = dot3(sub3(at3(o, tcs[j], d), c), ba);
      t_cap = fminf(t_cap, (yy <= 0.0f || yy >= baba) ? tcs[j] : kBig);
    }
  }
  return pick(pick(best, t_body, tmin, tmax), t_cap, tmin, tmax);
}

// The prim's normal at hit point h (the winner's, recomputed once): out of
// the centre, into it on the shell's inner surface (picked by radius), away
// from the capsule's nearest axis point.
__device__ V3 prim_normal(const float* pr, V3 h) {
  const int kind = static_cast<int>(pr[13]);
  const V3 c = {pr[0], pr[1], pr[2]};
  if (kind == 2) return para_normal(pr);
  if (kind == 3) {
    const V3 ba = sub3({pr[3], pr[4], pr[5]}, c);
    const float baba = fmaxf(dot3(ba, ba), 1e-12f);
    const float y = fminf(fmaxf(dot3(sub3(h, c), ba) / baba, 0.0f), 1.0f);
    const float r = fmaxf(pr[6], 1e-12f);
    const V3 axis = {c.x + y * ba.x, c.y + y * ba.y, c.z + y * ba.z};
    return {(h.x - axis.x) / r, (h.y - axis.y) / r, (h.z - axis.z) / r};
  }
  const V3 rel = sub3(h, c);
  const float rad = sqrtf(fmaxf(dot3(rel, rel), 1e-20f));
  V3 n = {rel.x / rad, rel.y / rad, rel.z / rad};
  if (kind == 1 && fabsf(rad - pr[3]) < fabsf(rad - pr[4])) {
    n = {-n.x, -n.y, -n.z};
  }
  return n;
}

template <int kGeom, bool kSpecular, bool kPbr, bool kPrims>
__global__ void __launch_bounds__(kThreads)
pt_fused_kernel(const float* __restrict__ tri, int m,
                const float* __restrict__ prims, int np,
                const float* __restrict__ mats, int k,
                const float* __restrict__ light,
                const float* __restrict__ cam,
                const long long* __restrict__ subframe_in,
                int width, int height, int full_w, int full_h, int y0,
                int spl, int max_depth, float* __restrict__ rad_out,
                int* __restrict__ count_out,
                const float* __restrict__ inst,
                const int* __restrict__ inst_rng, int ni,
                const float* __restrict__ corner,
                const float* __restrict__ bundles,
                const int* __restrict__ bundle_mip, int n_levels, int atlas_h,
                int atlas_w) {
  // Shared: triangles [m,16] (col 15 = material id), prims [np,16],
  // materials [k,16], light [16], camera [2,16]; with kInst the instances
  // [ni,16] and their ranges [ni,2].
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_prim = s_tri + 16 * m;
  float* s_mat = s_prim + 16 * np;
  float* s_light = s_mat + 16 * k;
  float* s_cam = s_light + 16;
  float* s_inst = s_cam + 32;
  int* s_rng = reinterpret_cast<int*>(s_inst + 16 * ni);
  for (int i = threadIdx.x; i < 16 * m; i += blockDim.x) s_tri[i] = tri[i];
  if constexpr (kPrims) {
    for (int i = threadIdx.x; i < 16 * np; i += blockDim.x) s_prim[i] = prims[i];
  }
  for (int i = threadIdx.x; i < 16 * k; i += blockDim.x) s_mat[i] = mats[i];
  for (int i = threadIdx.x; i < 16; i += blockDim.x) s_light[i] = light[i];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) s_cam[i] = cam[i];
  if constexpr (kGeom == kInst) {
    for (int i = threadIdx.x; i < 16 * ni; i += blockDim.x) s_inst[i] = inst[i];
    for (int i = threadIdx.x; i < 2 * ni; i += blockDim.x) s_rng[i] = inst_rng[i];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width * height) return;
  const int gx = p % width;
  const int gy = p / width + y0;
  const uint32_t pixel_index =
      static_cast<uint32_t>(gy) * static_cast<uint32_t>(full_w) +
      static_cast<uint32_t>(gx);
  const uint32_t subframe0 = static_cast<uint32_t>(*subframe_in);

  const V3 eye = {s_cam[0], s_cam[1], s_cam[2]};
  const V3 U = {s_cam[3], s_cam[4], s_cam[5]};
  const V3 V = {s_cam[6], s_cam[7], s_cam[8]};
  const V3 W = {s_cam[9], s_cam[10], s_cam[11]};
  const float aperture = s_cam[12], focal = s_cam[13];
  const bool is_ortho = s_cam[14] > 0.0f;
  const float ohx = s_cam[16], ohy = s_cam[17];
  const V3 miss = {s_cam[18], s_cam[19], s_cam[20]};
  const float spread = s_cam[21];   // kTex: the ray cone's pixel spread
  const V3 lc = {s_light[0], s_light[1], s_light[2]};
  const V3 lv1 = {s_light[3], s_light[4], s_light[5]};
  const V3 lv2 = {s_light[6], s_light[7], s_light[8]};
  const V3 ln = {s_light[9], s_light[10], s_light[11]};
  const V3 lem = {s_light[12], s_light[13], s_light[14]};
  const float larea = s_light[15];

  const float ulen = sqrtf(fmaxf(dot3(U, U), 1e-20f));
  const float vlen = sqrtf(fmaxf(dot3(V, V), 1e-20f));
  const float wlen = sqrtf(fmaxf(dot3(W, W), 1e-20f));
  const V3 un = {U.x / ulen, U.y / ulen, U.z / ulen};
  const V3 vn = {V.x / vlen, V.y / vlen, V.z / vlen};
  const V3 wn = {W.x / wlen, W.y / wlen, W.z / wlen};
  const float gxf = static_cast<float>(gx), gyf = static_cast<float>(gy);
  const float full_wf = static_cast<float>(full_w);
  const float full_hf = static_cast<float>(full_h);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int count = 0;
  for (int s = 0; s < spl; ++s) {
    // --- raygen (pallas_pt.py raygen_state) ---
    uint32_t rng = ort::tea4(pixel_index, subframe0 + static_cast<uint32_t>(s));
    const float jx = ort::uniform(rng);
    const float jy = ort::uniform(rng);
    const float ndc_x = 2.0f * ((gxf + jx) / full_wf) - 1.0f;
    const float ndc_y = 1.0f - 2.0f * ((gyf + jy) / full_hf);
    V3 d = normalize3({ndc_x * U.x + ndc_y * V.x + W.x,
                       ndc_x * U.y + ndc_y * V.y + W.y,
                       ndc_x * U.z + ndc_y * V.z + W.z});
    V3 o = eye;
    if (is_ortho) {
      o = {eye.x + ndc_x * ohx * un.x + ndc_y * ohy * vn.x,
           eye.y + ndc_x * ohx * un.y + ndc_y * ohy * vn.y,
           eye.z + ndc_x * ohx * un.z + ndc_y * ohy * vn.z};
      d = wn;
    }
    const float lu1 = ort::uniform(rng);   // thin-lens pair, always drawn
    const float lu2 = ort::uniform(rng);
    if (aperture > 0.0f) {
      const float r_l = sqrtf(lu1) * aperture;
      const float phi = kTwoPi * lu2;
      const float c = r_l * cosf(phi), sn = r_l * sinf(phi);
      const V3 f = {o.x + focal * d.x, o.y + focal * d.y, o.z + focal * d.z};
      o = {o.x + (c * un.x + sn * vn.x), o.y + (c * un.y + sn * vn.y),
           o.z + (c * un.z + sn * vn.z)};
      d = normalize3({f.x - o.x, f.y - o.y, f.z - o.z});
    }

    V3 thr = {1.f, 1.f, 1.f};
    V3 rad = {0.f, 0.f, 0.f};
    bool prev_spec = true;
    float tmin = 1e-4f;           // camera rays: Rays.make's default tmin
    float plen = 0.0f;            // kTex: the path length to the last hit
    for (int depth = 0; depth < max_depth; ++depth) {
      // --- closest hit: triangles, then prims (a triangle wins ties) ---
      float bt = 1e16f;
      int bid = -1;
      const float* bc = nullptr;
      const float* bxf = nullptr;   // kInst: the winner's instance row
      float bu = 0.0f, bv = 0.0f;   // kSmooth: the winner's barycentrics
      if constexpr (kGeom == kInst) {
        for (int i = 0; i < ni; ++i) {
          const float* xf = s_inst + 16 * i;
          const V3 io = xf_point(xf, o);
          const V3 id = xf_vector(xf, d);
          const int hi = s_rng[2 * i + 1];
          for (int t = s_rng[2 * i]; t < hi; ++t) {
            const float* c = s_tri + 16 * t;
            float tt, uu, vv, dpz;
            ort::tri_test(c, io.x, io.y, io.z, id.x, id.y, id.z, tt, uu, vv,
                          dpz);
            if (ort::tri_accept(tt, uu, vv, dpz, tmin, bt)) {
              bt = tt; bid = t; bc = c; bxf = xf;
            }
          }
        }
      } else {
        for (int t = 0; t < m; ++t) {
          const float* c = s_tri + 16 * t;
          float tt, uu, vv, dpz;
          ort::tri_test(c, o.x, o.y, o.z, d.x, d.y, d.z, tt, uu, vv, dpz);
          if (ort::tri_accept(tt, uu, vv, dpz, tmin, bt)) {
            bt = tt; bid = t; bc = c;
            if constexpr (kGeom == kSmooth || kGeom == kTex) {
              bu = uu; bv = vv;
            }
          }
        }
      }
      const float* bp = nullptr;    // the winning prim's row
      if constexpr (kPrims) {
        for (int q = 0; q < np; ++q) {
          const float tp = prim_t(s_prim + 16 * q, o, d, tmin, bt);
          if (tp < bt) {
            bt = tp; bp = s_prim + 16 * q;
          }
        }
      }
      count += 1;
      if (bid < 0 && bp == nullptr) {   // miss: constant background, ends
        rad.x += thr.x * miss.x;
        rad.y += thr.y * miss.y;
        rad.z += thr.z * miss.z;
        break;
      }
      const V3 hp = {o.x + bt * d.x, o.y + bt * d.y, o.z + bt * d.z};
      V3 gn;
      const float* mt;
      const float* attr = nullptr;  // kTex: the triangle winner's plane row
      if (kPrims && bp != nullptr) {
        gn = prim_normal(bp, hp);
        mt = s_mat + 16 * static_cast<int>(bp[12]);
      } else {
        gn = {bc[12], bc[13], bc[14]};
        int mid = static_cast<int>(bc[15]);
        if constexpr (kGeom == kInst) {
          gn = unit_world_normal(bxf, gn);
          mid += static_cast<int>(bxf[12]);
        }
        if constexpr (kGeom == kSmooth) {
          gn = smooth_normal(corner + 9 * bid, bu, bv, gn);
        }
        if constexpr (kGeom == kTex) {
          attr = corner + kTexAttrCols * bid;
          gn = smooth_normal(attr, bu, bv, gn);
        }
        mt = s_mat + 16 * mid;
      }
      V3 alb = {mt[1], mt[2], mt[3]};
      V3 em = {mt[4], mt[5], mt[6]};
      float metal = 0.0f, rough = 0.0f;
      if constexpr (kSpecular || kPbr) {
        metal = mt[7];
        rough = mt[12];
      }
      if constexpr (kGeom == kTex) {
        // --- the texture lanes (engine._texture_lanes) ---
        const int bundle = static_cast<int>(mt[13]);
        if (attr != nullptr && bundle >= 0) {
          float a[19];
#pragma unroll
          for (int j = 0; j < 19; ++j) a[j] = __ldg(attr + j);
          const float w = (1.0f - bu) - bv;
          const float uvx = (w * a[9] + bu * a[11]) + bv * a[13];
          const float uvy = (w * a[10] + bu * a[12]) + bv * a[14];
          const float cone = spread * (plen + bt);
          const int flags = static_cast<int>(mt[14]);
          float ch[12];
          sample_bundle(bundles, bundle_mip, n_levels, atlas_h, atlas_w,
                        bundle, mt[15], flags >> kTexChainShift, uvx, uvy,
                        cone * a[18], ch);
          if (flags & kTexBase) {
            alb = {alb.x * ch[0], alb.y * ch[1], alb.z * ch[2]};
          }
          if (flags & kTexMr) {
            rough = rough * ch[10];
            metal = metal * ch[11];
          }
          if (flags & kTexEmissive) {
            em = {em.x * ch[7], em.y * ch[8], em.z * ch[9]};
          }
          if (flags & kTexNormal) {
            // tangent-space normal map: Gram-Schmidt the triangle's
            // tangent against the shading normal
            const float nmx = ch[4] * 2.0f - 1.0f;
            const float nmy = ch[5] * 2.0f - 1.0f;
            const float nmz = ch[6] * 2.0f - 1.0f;
            const V3 tg = {a[15], a[16], a[17]};
            const float tdn = dot3(tg, gn);
            V3 tv = {tg.x - gn.x * tdn, tg.y - gn.y * tdn,
                     tg.z - gn.z * tdn};
            const float tl = fmaxf(sqrtf(dot3(tv, tv)), 1e-8f);
            tv = {tv.x / tl, tv.y / tl, tv.z / tl};
            const V3 bv3 = {gn.y * tv.z - gn.z * tv.y,
                            gn.z * tv.x - gn.x * tv.z,
                            gn.x * tv.y - gn.y * tv.x};
            gn = normalize3({tv.x * nmx + bv3.x * nmy + gn.x * nmz,
                             tv.y * nmx + bv3.y * nmy + gn.y * nmz,
                             tv.z * nmx + bv3.z * nmy + gn.z * nmz});
          }
        }
        plen = plen + bt;
      }
      // two-sided normal: flip when it faces along the ray
      const float flip = (gn.x * d.x + gn.y * d.y + gn.z * d.z) > 0.0f
                             ? -1.0f : 1.0f;
      const V3 n = {gn.x * flip, gn.y * flip, gn.z * flip};
      if (prev_spec) {
        rad.x += thr.x * em.x;
        rad.y += thr.y * em.y;
        rad.z += thr.z * em.z;
      }
      // --- material lanes (engine._bounce) ---
      bool is_glass = false, is_mirror = false, is_pbr = false;
      if constexpr (kSpecular || kPbr) {
        is_glass = mt[0] == kGlass;
        is_mirror = mt[0] == kPbrKind && metal > 0.99f && rough <= 0.05f;
        is_pbr = kPbr && mt[0] == kPbrKind && !is_mirror;
      }
      const bool is_specular = is_glass || is_mirror;
      const V3 ta = {thr.x * alb.x, thr.y * alb.y, thr.z * alb.z};

      // --- NEE toward the parallelogram light (diffuse and PBR lanes) ---
      const float u1 = ort::uniform(rng);
      const float u2 = ort::uniform(rng);
      if (!is_specular) {
        const V3 lp = {lc.x + u1 * lv1.x + u2 * lv2.x,
                       lc.y + u1 * lv1.y + u2 * lv2.y,
                       lc.z + u1 * lv1.z + u2 * lv2.z};
        const V3 dl = {lp.x - hp.x, lp.y - hp.y, lp.z - hp.z};
        const float dist2 = fmaxf(dot3(dl, dl), 1e-12f);
        const float dist = sqrtf(dist2);
        const V3 wi = {dl.x / dist, dl.y / dist, dl.z / dist};
        const float n_dl = dot3(n, wi);
        const float ln_dl = fabsf(ln.x * wi.x + ln.y * wi.y + ln.z * wi.z);
        if (n_dl > 0.0f) {
          const float sh_tmax = dist * kShadowTmaxScale;
          bool occ = false;
          if constexpr (kGeom == kInst) {
            for (int i = 0; i < ni && !occ; ++i) {
              const float* xf = s_inst + 16 * i;
              const V3 so = xf_point(xf, hp);
              const V3 sd = xf_vector(xf, wi);
              const int hi = s_rng[2 * i + 1];
              for (int t = s_rng[2 * i]; t < hi && !occ; ++t) {
                float tt, uu, vv, dpz;
                ort::tri_test(s_tri + 16 * t, so.x, so.y, so.z, sd.x, sd.y,
                              sd.z, tt, uu, vv, dpz);
                occ = ort::tri_accept(tt, uu, vv, dpz, kRayTmin, sh_tmax);
              }
            }
          } else {
            for (int t = 0; t < m && !occ; ++t) {
              float tt, uu, vv, dpz;
              ort::tri_test(s_tri + 16 * t, hp.x, hp.y, hp.z, wi.x, wi.y,
                            wi.z, tt, uu, vv, dpz);
              occ = ort::tri_accept(tt, uu, vv, dpz, kRayTmin, sh_tmax);
            }
          }
          if constexpr (kPrims) {
            for (int q = 0; q < np && !occ; ++q) {
              occ = prim_t(s_prim + 16 * q, hp, wi, kRayTmin, sh_tmax) < kBig;
            }
          }
          if (!occ) {
            if (kPbr && is_pbr) {
              // full BRDF: ((T * f) * Le) * nDl * LnDl * A / d²
              const V3 f = pbr_brdf(n, {-d.x, -d.y, -d.z}, wi, alb, metal,
                                    rough);
              const float w2 = n_dl * ln_dl * larea / dist2;
              rad.x += thr.x * f.x * lem.x * w2;
              rad.y += thr.y * f.y * lem.y * w2;
              rad.z += thr.z * f.z * lem.z * w2;
            } else {
              const float w_l = n_dl * ln_dl * larea / (kPi * dist2);
              rad.x += ta.x * lem.x * w_l;
              rad.y += ta.y * lem.y * w_l;
              rad.z += ta.z * lem.z * w_l;
            }
          }
        }
        count += 1;                  // the shadow ray of a diffuse / PBR hit
      }

      // --- next direction and throughput ---
      const float b1 = ort::uniform(rng);
      const float b2 = ort::uniform(rng);
      V3 nd = cosine_sample(b1, b2, n);
      V3 nthr = ta;                  // diffuse: f * cos / pdf = albedo
      if constexpr (kPbr) {
        // one-sample MIS between the cosine and GGX lobes; all four draws
        // happen on every lane of a PBR scene
        const float u5p = ort::uniform(rng);
        const float u6p = ort::uniform(rng);
        const float u7p = ort::uniform(rng);
        (void)ort::uniform(rng);
        if (is_pbr) {
          const float rc = fmaxf(rough, 0.05f);
          const V3 d_ggx = normalize3(reflect3(d, ggx_half(u5p, u6p, n, rc)));
          const float p_spec = fminf(fmaxf(0.5f * metal + 0.1f, 0.05f), 0.95f);
          const V3 dp = u7p < p_spec ? d_ggx : nd;
          const V3 wo = {-d.x, -d.y, -d.z};
          const V3 f = pbr_brdf(n, wo, dp, alb, metal, rc);
          const float pdf = pbr_pdf(n, wo, dp, rc, p_spec);
          const float n_dl_p = fmaxf(dot3(n, dp), 0.0f);
          const bool valid = n_dl_p > 1e-5f && pdf > 1e-7f;
          const float sc = n_dl_p / fmaxf(pdf, 1e-7f);
          const V3 w = valid ? V3{f.x * sc, f.y * sc, f.z * sc}
                             : V3{0.0f, 0.0f, 0.0f};
          nd = dp;
          nthr = {thr.x * w.x, thr.y * w.y, thr.z * w.z};
        }
      }
      if constexpr (kSpecular) {
        const float u3 = ort::uniform(rng);   // the glass pair
        (void)ort::uniform(rng);
        if (is_specular) {
          const V3 mr = normalize3(reflect3(d, n));
          nd = mr;
          if (is_glass) {
            // Schlick Fresnel picks reflect / refract (vecmath.refract)
            const float ior = mt[8];
            const float eta = dot3(d, gn) < 0.0f ? 1.0f / ior : ior;
            const float dn = dot3(d, n);
            const float cos_i = -dn;
            const float sin2_t = (eta * eta) * fmaxf(1.0f - cos_i * cos_i, 0.0f);
            const bool refr_ok = sin2_t <= 1.0f;
            const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
            const float ci = fminf(fmaxf(-dn, 0.0f), 1.0f);
            const float r = (ior - 1.0f) / (ior + 1.0f);
            const float r0 = r * r;
            const float fresnel = r0 + (1.0f - r0) * pow5(1.0f - ci);
            if (refr_ok && !(u3 < fresnel)) {
              const float s_n = eta * cos_i - cos_t;
              nd = normalize3({eta * d.x + s_n * n.x, eta * d.y + s_n * n.y,
                               eta * d.z + s_n * n.z});
            }
          }
          const bool has_kr = mt[9] > 0.0f || mt[10] > 0.0f || mt[11] > 0.0f;
          const V3 tint = has_kr ? V3{mt[9], mt[10], mt[11]} : alb;
          nthr = {thr.x * tint.x, thr.y * tint.y, thr.z * tint.z};
        }
      } else {
        ort::advance2(rng);          // the glass pair, drawn unused
      }
      const float off = (dot3(nd, n) >= 0.0f ? 1.0f : -1.0f) * kRayTmin;
      o = {hp.x + n.x * off, hp.y + n.y * off, hp.z + n.z * off};
      d = nd;
      tmin = kRayTmin;
      prev_spec = is_specular;

      // --- Russian roulette from depth 1 ---
      const float u5 = ort::uniform(rng);
      (void)ort::uniform(rng);
      const float q = fminf(fmaxf(fmaxf(nthr.x, fmaxf(nthr.y, nthr.z)), 0.05f),
                            1.0f);
      thr = nthr;
      if (depth >= 1) {
        if (u5 >= q) break;
        thr = {nthr.x / q, nthr.y / q, nthr.z / q};
      }
    }
    acc_r += rad.x;
    acc_g += rad.y;
    acc_b += rad.z;
  }
  rad_out[3 * p] = acc_r;
  rad_out[3 * p + 1] = acc_g;
  rad_out[3 * p + 2] = acc_b;
  count_out[p] = count;
}

// Launches geometry mode kGeom's instantiation <specular, pbr, prims> (each
// source that includes this header instantiates one mode).
template <int kGeom>
void launch_geometry(const FusedArgs& a, bool specular, bool pbr,
                     bool prims) {
  using Kernel = decltype(&pt_fused_kernel<kGeom, false, false, false>);
  // Indexed by specular * 4 + pbr * 2 + prims.
  constexpr Kernel kVariants[8] = {
      pt_fused_kernel<kGeom, false, false, false>,
      pt_fused_kernel<kGeom, false, false, true>,
      pt_fused_kernel<kGeom, false, true, false>,
      pt_fused_kernel<kGeom, false, true, true>,
      pt_fused_kernel<kGeom, true, false, false>,
      pt_fused_kernel<kGeom, true, false, true>,
      pt_fused_kernel<kGeom, true, true, false>,
      pt_fused_kernel<kGeom, true, true, true>};
  const int n = a.width * a.height;
  const int ni = kGeom == kInst ? a.ni : 0;
  const size_t smem = sizeof(float) * (16 * (a.m + a.np + a.k + ni) + 16 + 32)
                      + sizeof(int) * 2 * ni;
  kVariants[(specular ? 4 : 0) + (pbr ? 2 : 0) + (prims ? 1 : 0)]
      <<<(n + kThreads - 1) / kThreads, kThreads, smem, a.stream>>>(
          a.tri, a.m, a.prims, a.np, a.mats, a.k, a.light, a.cam, a.subframe,
          a.width, a.height, a.full_w, a.full_h, a.y0, a.spl, a.max_depth,
          a.rad, a.count, a.inst, a.inst_rng, ni, a.corner, a.bundles,
          a.bundle_mip, a.n_levels, a.atlas_h, a.atlas_w);
}

}  // namespace
}  // namespace ort_fused
