// The hit data of a bounce, for Hopper (sm_90a): two kernels in place of
// the PyTorch ops of render/integrator.py's hit-data phase.
//
// Replaces no TPU kernel: the JAX package computes a bounce's hit data with
// XLA ops (elevenrender_tpu/ops/intersect.py full_hit,
// elevenrender_tpu/render/integrator.py _generate_hitdata), which the port
// first ran as several hundred single-op PyTorch kernels a bounce, each
// writing its [N] or [N, 3] intermediate to memory and reading it back.
//
// hitdata_tri_gather, one lane a ray: the packed [T, 40] triangle row at
// the clamped hit id (ops/intersect.py gather_tri), Moller-Trumbore, the
// interpolated uv, shading normal and tangent, the geometric normal
// flipped against the ray, the shadow-terminator projection with its
// convex test and the bitangent (full_hit).  It writes position, normal,
// gnormal, tangent and bitangent as five [N, 3] arrays, tu and tv as two
// [N] arrays and the material id as [N] int64.
//
// hitdata_material_gather, one lane a hit: the material row at the
// material id, the texture taps of every bound slot, each texture by its
// own filter or by the one filter every texture shares (ops/texture.py
// sample_filtered, sample_nearest, fetch_texel: int32 conversion toward
// zero with NaN -> 0 and saturation, C's % then the absolute value, the
// channel broadcast), the nearest normal map with its y flip, the
// fallback of an unbound slot to the material's constant, and the ^2.2 of
// roughness and metallic (_generate_hitdata).  It writes albedo, emission
// and, with a normal map, the mapped normal as [N, 3] arrays, and the 13
// scalars of the material row (integrator.py _SCALAR_FIELDS order) as
// [N] arrays.
//
// Bit for bit: every float op is the PyTorch op's, on the same operands in
// the same order, each rounded on its own (--fmad=false; division and
// square root correctly rounded, nvcc's default), clamps that pass NaN
// through as torch.clamp does, and powf for torch.pow.  So both paths give
// the same float32 values on every lane, dead lanes (hit id -1, which
// reads row 0) and NaNs included.
//
// What bounds them: memory.  A lane of the first reads its hit id, its ray
// and a 144-byte slice of its 160-byte row and writes 76 bytes; a lane of
// the second reads its hit's uv and id, the frame where a normal map is
// bound, a material row (a table of a few rows, in cache) and one texel
// row of 16 bytes a nearest tap, four a bilinear one, and writes 76
// bytes, 88 with a normal map.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScalars = 13;  // integrator.py _SCALAR_FIELDS
constexpr int kSlots = 7;     // scene/material.py MAP_SLOTS
constexpr int kNormalSlot = 4;
constexpr int kFilterNone = 0;
constexpr int kFilterBilinear = 1;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// a * s[..., None]
__device__ __forceinline__ V3 mul(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

// core/vecmath.py dot: the products, then (x + y) + z.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float px = a.x * b.x;
  const float py = a.y * b.y;
  const float pz = a.z * b.z;
  return (px + py) + pz;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// core/vecmath.py normalize: a / clamp(sqrt(dot(a, a)), min=1e-12).
__device__ __forceinline__ V3 normalize(V3 a) {
  const float l = clamp_min(sqrtf(dot(a, a)), 1e-12f);
  return {a.x / l, a.y / l, a.z / l};
}

// p0 + (p1 - p0) * u + (p2 - p0) * v, left to right.
__device__ __forceinline__ V3 interp(V3 p0, V3 p1, V3 p2, float u, float v) {
  return add(add(p0, mul(sub(p1, p0), u)), mul(sub(p2, p0), v));
}

// p + t * (q - p): core/vecmath.py lerp.
__device__ __forceinline__ V3 lerp(V3 p, V3 q, float t) {
  const V3 d = sub(q, p);
  return add(p, {t * d.x, t * d.y, t * d.z});
}

__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// ops/texture.py _to_i32: toward zero, NaN -> 0, saturating at the int32
// range.
__device__ __forceinline__ int to_i32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  return static_cast<int>(fminf(fmaxf(x, -2147483648.0f), 2147483520.0f));
}

__device__ __forceinline__ int trunc_i32(float f) { return to_i32(truncf(f)); }

// ops/texture.py _trunc_mod_abs: |x| in int32 (|INT_MIN| stays INT_MIN),
// then the floor remainder by m, as torch.remainder takes it.
__device__ __forceinline__ int trunc_mod_abs(int x, int m) {
  long long a = x < 0 ? -static_cast<long long>(x) : x;
  if (a == 2147483648LL) a = -2147483648LL;
  const long long mm = m;
  long long r = a % mm;
  if (r != 0 && ((r < 0) != (mm < 0))) r += mm;
  return static_cast<int>(r);
}

struct Atlas {
  const float4* data;  // [P, 4] texel rows
  long long rows;      // P
  const int* off;      // [K] first row of each texture
  const int* w;
  const int* h;
  const int* ch;
  const int* filter;
  int count;           // K
};

// ops/texture.py fetch_texel: texel (x, y) of texture t, wrapped; one
// channel broadcasts to grey, two give (r, g, 0).
__device__ __forceinline__ V3 fetch(const Atlas& at, int t, int x, int y) {
  const int w = at.w[t];
  const int h = at.h[t];
  const int c = at.ch[t];
  const int xx = trunc_mod_abs(x, w);
  const int yy = trunc_mod_abs(y, h);
  // off + y * w + x in int32, wrapping as the int32 tensors do.
  const int base = static_cast<int>(static_cast<unsigned>(at.off[t]) +
                                    static_cast<unsigned>(yy) *
                                        static_cast<unsigned>(w) +
                                    static_cast<unsigned>(xx));
  long long b = base < 0 ? 0 : base;
  if (b > at.rows - 1) b = at.rows - 1;
  const float4 row = __ldg(at.data + b);
  const float c0 = row.x;
  const float g = c >= 2 ? row.y : c0;
  const float bl = c >= 3 ? row.z : (c == 1 ? c0 : 0.0f);
  return {c0, g, bl};
}

__device__ __forceinline__ V3 sample_nearest(const Atlas& at, int t, float u,
                                             float v) {
  const float w = static_cast<float>(at.w[t]);
  const float h = static_cast<float>(at.h[t]);
  return fetch(at, t, trunc_i32(u * w), trunc_i32(v * h));
}

__device__ __forceinline__ V3 sample_bilinear(const Atlas& at, int t, float u,
                                              float v) {
  const float w = static_cast<float>(at.w[t]);
  const float h = static_cast<float>(at.h[t]);
  const float x = u * w;
  const float y = v * h;
  const float t1x = floorf(x);
  const float t1y = floorf(y);
  const float a = x - t1x;
  const float b = y - t1y;
  const V3 v1 = fetch(at, t, trunc_i32(t1x), trunc_i32(t1y));
  const V3 v2 = fetch(at, t, trunc_i32(t1x + 1.0f), trunc_i32(t1y));
  const V3 v3 = fetch(at, t, trunc_i32(t1x), trunc_i32(t1y + 1.0f));
  const V3 v4 = fetch(at, t, trunc_i32(t1x + 1.0f), trunc_i32(t1y + 1.0f));
  return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b);
}

// ops/texture.py sample_filtered: uniform names the filter every texture
// shares, or -1 for a mixed atlas, where the nearest lanes put all four
// taps on their texel with zero lerp weights.
__device__ __forceinline__ V3 sample_filtered(const Atlas& at, int t, float u,
                                              float v, int uniform) {
  if (uniform == kFilterNone) return sample_nearest(at, t, u, v);
  if (uniform == kFilterBilinear) return sample_bilinear(at, t, u, v);
  const float w = static_cast<float>(at.w[t]);
  const float h = static_cast<float>(at.h[t]);
  const bool bil = at.filter[t] == kFilterBilinear;
  const float x = u * w;
  const float y = v * h;
  const float t1x = floorf(x);
  const float t1y = floorf(y);
  const float a = bil ? x - t1x : 0.0f;
  const float b = bil ? y - t1y : 0.0f;
  const float nx = static_cast<float>(trunc_i32(x));
  const float ny = static_cast<float>(trunc_i32(y));
  const float x0 = bil ? t1x : nx;
  const float y0 = bil ? t1y : ny;
  const float x1 = bil ? t1x + 1.0f : nx;
  const float y1 = bil ? t1y + 1.0f : ny;
  const V3 v1 = fetch(at, t, trunc_i32(x0), trunc_i32(y0));
  const V3 v2 = fetch(at, t, trunc_i32(x1), trunc_i32(y0));
  const V3 v3 = fetch(at, t, trunc_i32(x0), trunc_i32(y1));
  const V3 v4 = fetch(at, t, trunc_i32(x1), trunc_i32(y1));
  return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b);
}

// A texture id as the PyTorch path indexes with it: clamped at 0 (the
// unbound slot's -1 reads texture 0), and kept inside the table.
__device__ __forceinline__ int texture_row(int tid, int count) {
  const int t = tid < 0 ? 0 : tid;
  return t < count ? t : count - 1;
}

// Rows of a table indexed as tensor[i] is, for an index in range; an index
// out of range (which the PyTorch path refuses) is kept inside the table.
__device__ __forceinline__ long long table_row(long long i, long long rows) {
  if (i < 0) i += rows;
  if (i < 0) i = 0;
  return i < rows ? i : rows - 1;
}

__global__ void __launch_bounds__(kThreads)
hitdata_tri_gather(const float* __restrict__ packed, long long t_rows,
                   long long p_rows, const long long* __restrict__ hit,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d, int n,
                   float* __restrict__ vec, float* __restrict__ uv,
                   long long* __restrict__ mat) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // integrator.py clamps the id at 0, gather_tri into [0, T - 1]; a
  // negative result (no triangles) indexes from the end as tensor[-1].
  long long s = hit[i];
  s = s < 0 ? 0 : s;
  s = s > t_rows - 1 ? t_rows - 1 : s;
  if (s < 0) s += p_rows;
  // Columns 0:36 of the row (verts 0:9, normals 9:18, uvs 18:24, tangents
  // 24:33, sign 33, material id 34) as nine 16-byte loads.
  const float4* row4 = reinterpret_cast<const float4*>(packed + s * 40);
  float r[36];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float4 q = __ldg(row4 + k);
    r[4 * k] = q.x;
    r[4 * k + 1] = q.y;
    r[4 * k + 2] = q.z;
    r[4 * k + 3] = q.w;
  }
  const V3 v0 = {r[0], r[1], r[2]};
  const V3 v1 = {r[3], r[4], r[5]};
  const V3 v2 = {r[6], r[7], r[8]};
  const V3 n0 = {r[9], r[10], r[11]};
  const V3 n1 = {r[12], r[13], r[14]};
  const V3 n2 = {r[15], r[16], r[17]};
  const V3 tg0 = {r[24], r[25], r[26]};
  const V3 tg1 = {r[27], r[28], r[29]};
  const V3 tg2 = {r[30], r[31], r[32]};
  const V3 o = load3(ray_o + 3LL * i);
  const V3 d = load3(ray_d + 3LL * i);

  // ops/intersect.py moller_trumbore (its valid flag is read by nobody).
  const V3 edge1 = sub(v1, v0);
  const V3 edge2 = sub(v2, v0);
  const V3 pvec = cross(d, edge2);
  const float det = dot(edge1, pvec);
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  const V3 tvec = sub(o, v0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, edge1);
  const float v = dot(d, qvec) * inv_det;
  const float t = dot(edge2, qvec) * inv_det;

  // full_hit.
  const float tu = (r[18] + (r[20] - r[18]) * u) + (r[22] - r[18]) * v;
  const float tv = (r[19] + (r[21] - r[19]) * u) + (r[23] - r[19]) * v;
  const V3 geom_pos = add(o, mul(d, t));
  const V3 shading_normal = normalize(interp(n0, n1, n2, u, v));
  V3 comp_normal = normalize(cross(edge1, edge2));
  if (dot(comp_normal, d) > 0.0f) {
    comp_normal = {-comp_normal.x, -comp_normal.y, -comp_normal.z};
  }
  const V3 shading_tangent = interp(tg0, tg1, tg2, u, v);
  const V3 p0 = sub(geom_pos, mul(n0, dot(sub(geom_pos, v0), n0)));
  const V3 p1 = sub(geom_pos, mul(n1, dot(sub(geom_pos, v1), n1)));
  const V3 p2 = sub(geom_pos, mul(n2, dot(sub(geom_pos, v2), n2)));
  const V3 shading_pos = interp(p0, p1, p2, u, v);
  const bool convex = dot(sub(shading_pos, geom_pos), shading_normal) > 0.0f;
  const V3 position = convex ? shading_pos : geom_pos;
  const float sign = r[33];
  const V3 c = cross(shading_normal, shading_tangent);
  const V3 bitangent = {sign * c.x, sign * c.y, sign * c.z};

  const long long plane = 3LL * n;
  float* out = vec + 3LL * i;
  store3(out, position);
  store3(out + plane, shading_normal);
  store3(out + 2 * plane, comp_normal);
  store3(out + 3 * plane, shading_tangent);
  store3(out + 4 * plane, bitangent);
  uv[i] = tu;
  uv[n + i] = tv;
  mat[i] = static_cast<long long>(r[34]);
}

struct Materials {
  const float* albedo;    // [M, 3]
  const float* emission;  // [M, 3]
  const float* scalar[kScalars];  // [M] each
  const int* tex;         // [M, kSlots] texture ids, -1 unbound
  long long rows;         // M
};

__global__ void __launch_bounds__(kThreads)
hitdata_material_gather(const long long* __restrict__ mat,
                        const float* __restrict__ tu_in,
                        const float* __restrict__ tv_in,
                        const float* __restrict__ normal,
                        const float* __restrict__ tangent,
                        const float* __restrict__ bitangent, int n,
                        Materials mats, Atlas at, int used, int uniform,
                        float* __restrict__ vec, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = table_row(mat[i], mats.rows);
  const float tu = tu_in[i];
  const float tv = tv_in[i];
  V3 albedo = load3(mats.albedo + 3 * m);
  V3 emission = load3(mats.emission + 3 * m);
  float scalar[kScalars];
#pragma unroll
  for (int k = 0; k < kScalars; ++k) scalar[k] = __ldg(mats.scalar[k] + m);
  int tex[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) tex[k] = __ldg(mats.tex + kSlots * m + k);

  // Each bound slot of a used column replaces the material's constant: an
  // unbound one (-1) keeps it, so its taps are not read.
  if ((used & 1) && tex[0] >= 0) {
    albedo = sample_filtered(at, texture_row(tex[0], at.count), tu, tv,
                             uniform);
  }
  if ((used & 2) && tex[1] >= 0) {
    emission = sample_filtered(at, texture_row(tex[1], at.count), tu, tv,
                               uniform);
  }
  // Slots 2, 3, 5, 6: roughness, metallic, opacity, transmission, which are
  // _SCALAR_FIELDS 0-3.
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int slot = k < 2 ? k + 2 : k + 3;
    if ((used >> slot & 1) && tex[slot] >= 0) {
      scalar[k] = sample_filtered(at, texture_row(tex[slot], at.count), tu,
                                  tv, uniform).x;
    }
  }
  const long long plane = 3LL * n;
  float* o = vec + 3LL * i;
  if (used >> kNormalSlot & 1) {
    // Nearest fetch, tangent-space y flipped.
    const V3 nrm = load3(normal + 3LL * i);
    V3 mapped = nrm;
    const int ntid = tex[kNormalSlot];
    if (ntid >= 0) {
      const V3 t = sample_nearest(at, texture_row(ntid, at.count), tu, tv);
      const float l0 = t.x * 2.0f - 1.0f;
      const float l1 = t.y * 2.0f - 1.0f;
      const float l2 = t.z * 2.0f - 1.0f;
      mapped = normalize(add(sub(mul(load3(tangent + 3LL * i), l0),
                                 mul(load3(bitangent + 3LL * i), l1)),
                             mul(nrm, l2)));
    }
    store3(o + 2 * plane, mapped);
  }
  scalar[0] = powf(scalar[0], 2.2f);
  scalar[1] = powf(scalar[1], 2.2f);
  store3(o, albedo);
  store3(o + plane, emission);
#pragma unroll
  for (int k = 0; k < kScalars; ++k) {
    out[static_cast<long long>(k) * n + i] = scalar[k];
  }
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int hitdata_threads() { return kThreads; }

int hitdata_scalars() { return kScalars; }

int hitdata_slots() { return kSlots; }

// All pointers but `scalars` are device pointers.  packed: [p_rows, 40]
// float32, 16-byte aligned; t_rows: the triangles (gather_tri's clamp);
// hit: [n] int64; ray_o, ray_d: [n, 3] float32; vec: [5, n, 3] float32
// (position, normal, gnormal, tangent, bitangent); uv: [2, n] float32 (tu,
// tv); mat: [n] int64.  Returns the launch's cudaError_t (0 on success).
int hitdata_tri(const void* packed, long long t_rows, long long p_rows,
                const void* hit, const void* ray_o, const void* ray_d, int n,
                void* vec, void* uv, void* mat, void* stream) {
  if (n <= 0) return 0;
  hitdata_tri_gather<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), t_rows, p_rows,
      static_cast<const long long*>(hit), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), n, static_cast<float*>(vec),
      static_cast<float*>(uv), static_cast<long long*>(mat));
  return launch_error();
}

// mat: [n] int64; tu, tv: [n]; normal, tangent, bitangent: [n, 3] (read
// only with a normal map); albedo, emission: [m_rows, 3]; scalars: a host
// array of 13 device pointers, [m_rows] each, in _SCALAR_FIELDS order;
// tex: [m_rows, 7] int32; data: [p_rows, 4] float32, 16-byte aligned;
// off, w, h, ch, filter: [k_rows] int32; used: bit s set where slot s is
// bound by some material; uniform: the atlas's one filter or -1; vec:
// [2 or 3, n, 3] (albedo, emission, and the mapped normal when bit 4 of
// used is set); out: [13, n] float32.
int hitdata_material(const void* mat, const void* tu, const void* tv,
                     const void* normal,
                     const void* tangent, const void* bitangent, int n,
                     const void* albedo, const void* emission,
                     const void* const* scalars, const void* tex,
                     long long m_rows, const void* data, long long p_rows,
                     const void* off, const void* w, const void* h,
                     const void* ch, const void* filter, int k_rows, int used,
                     int uniform, void* vec, void* out, void* stream) {
  if (n <= 0) return 0;
  Materials mats;
  mats.albedo = static_cast<const float*>(albedo);
  mats.emission = static_cast<const float*>(emission);
  for (int k = 0; k < kScalars; ++k) {
    mats.scalar[k] = static_cast<const float*>(scalars[k]);
  }
  mats.tex = static_cast<const int*>(tex);
  mats.rows = m_rows;
  Atlas at;
  at.data = static_cast<const float4*>(data);
  at.rows = p_rows;
  at.off = static_cast<const int*>(off);
  at.w = static_cast<const int*>(w);
  at.h = static_cast<const int*>(h);
  at.ch = static_cast<const int*>(ch);
  at.filter = static_cast<const int*>(filter);
  at.count = k_rows;
  hitdata_material_gather<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(mat), static_cast<const float*>(tu),
      static_cast<const float*>(tv),
      static_cast<const float*>(normal), static_cast<const float*>(tangent),
      static_cast<const float*>(bitangent), n, mats, at, used, uniform,
      static_cast<float*>(vec), static_cast<float*>(out));
  return launch_error();
}

const char* hitdata_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
