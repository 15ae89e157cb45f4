// Stage marks of the captured odometry step (evaluation/profiling.py).
//
// One empty kernel per stage, named velo_stage_<stage>, and
// velo_stage_end.  profiling.stage() enqueues a stage's mark while a CUDA
// graph of the step is being captured, so every replay of the graph shows
// on the device trace's clock where each stage begins: a mark opens a
// stage, and the stage lasts until the next mark.  A mark does no work: a
// replay runs ~15 of them (~55 with the voxel-hash engine) against
// 10k-66k kernels of the step.
//
// The kernels are defined, and listed in kMarks, in the order of
// profiling.MARKS: mark i is kernel i.

#include <cuda_runtime.h>

extern "C" __global__ void velo_stage_lidar_front() {}
extern "C" __global__ void velo_stage_vision_front() {}
extern "C" __global__ void velo_stage_solve() {}
extern "C" __global__ void velo_stage_search() {}
extern "C" __global__ void velo_stage_hash_build() {}
extern "C" __global__ void velo_stage_hash_query() {}
extern "C" __global__ void velo_stage_map_refine() {}
extern "C" __global__ void velo_stage_map_update() {}
extern "C" __global__ void velo_stage_vision_book() {}
extern "C" __global__ void velo_stage_carry() {}
extern "C" __global__ void velo_stage_end() {}

namespace {

void (*const kMarks[])() = {
    velo_stage_lidar_front, velo_stage_vision_front, velo_stage_solve,
    velo_stage_search,      velo_stage_hash_build,   velo_stage_hash_query,
    velo_stage_map_refine,  velo_stage_map_update,   velo_stage_vision_book,
    velo_stage_carry,       velo_stage_end,
};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Enqueue mark `mark` (an index into kMarks) on `stream`, a cudaStream_t of
// the current device.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int velo_stage_mark(int mark, void* stream) {
  if (mark < 0 || mark >= kNumMarks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kMarks[mark]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
