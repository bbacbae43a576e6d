// The host side of the scans' backward from the checkpoints (wkv6_bwd.cu,
// ssd_bwd.cu): one C call issues every launch of a backward from a plan,
// the rows (op, segment, stream, event) that `kernels/wkv6.py::
// checkpoint_plan` makes.  Records and waits are issued here; a pass runs
// through the caller's `issue(op, segment, stream)`.
//
// Streams: 0 is the caller's (the current PyTorch stream); 1 (the
// recompute) and 2 (the reverse passes) are made once per device with the
// device's greatest priority, so their few blocks take SMs ahead of the
// chunk passes' many; 3 (every other chunk pass) at the least, as
// PyTorch's own streams.  All three are non-blocking and ordered against
// the caller's stream by the plan's events alone: the plan forks them
// from stream 0 first and joins them into it last, so whatever the
// caller's stream does after the call (freeing the workspace included)
// follows every launch.  One backward at a time per device holds the
// streams and events (a mutex).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace ckpt {

// a plan row's op; its stream in 0 .. kStreams - 1, its event (records and
// waits) in 0 .. kEvents - 1
enum Op : int {
  kRecord = 0,      // record event on stream
  kWait = 1,        // stream waits for event's last record
  kRecompute = 2,   // segment's states from its checkpoint
  kReverse = 3,     // segment's reverse pass (its dS, the carry down)
  kChunkPass = 4,   // segment's chunk pass
  kSums = 5,        // the fixed-order sums, once
};
constexpr int kStreams = 4;
constexpr int kEvents = 10;
constexpr int kMaxDevices = 64;

struct Lanes {
  cudaStream_t s[kStreams];
  cudaEvent_t e[kEvents];
};

// the side streams and events of the current device, made at first use
inline cudaError_t lanes_of(int device, Lanes* out) {
  static Lanes made[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    int least = 0, greatest = 0;
    cudaError_t err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    for (int i = 1; i < kStreams && err == cudaSuccess; ++i)
      err = cudaStreamCreateWithPriority(&made[device].s[i],
                                         cudaStreamNonBlocking,
                                         i < 3 ? greatest : least);
    for (int i = 0; i < kEvents && err == cudaSuccess; ++i)
      err = cudaEventCreateWithFlags(&made[device].e[i],
                                     cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  *out = made[device];
  return cudaSuccess;
}

// Issues the n_steps rows of `plan` on `device` from `caller`'s stream:
// records and waits here, every other op through issue(op, segment,
// stream), which returns its launches' error.  Returns the first error
// (cudaErrorInvalidValue for a row out of range).
template <typename F>
cudaError_t run(const int* plan, int n_steps, int device, cudaStream_t caller,
                F&& issue) {
  if (device < 0 || device >= kMaxDevices || !plan || n_steps < 0)
    return cudaErrorInvalidValue;
  static std::mutex locks[kMaxDevices];
  std::lock_guard<std::mutex> hold(locks[device]);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  Lanes lanes;
  if (err == cudaSuccess) err = lanes_of(device, &lanes);
  lanes.s[0] = caller;
  for (int i = 0; i < n_steps && err == cudaSuccess; ++i) {
    const int op = plan[4 * i], seg = plan[4 * i + 1];
    const int s = plan[4 * i + 2], e = plan[4 * i + 3];
    const bool event = op == kRecord || op == kWait;
    if (s < 0 || s >= kStreams || (event && (e < 0 || e >= kEvents))) {
      err = cudaErrorInvalidValue;
    } else if (op == kRecord) {
      err = cudaEventRecord(lanes.e[e], lanes.s[s]);
    } else if (op == kWait) {
      err = cudaStreamWaitEvent(lanes.s[s], lanes.e[e], 0);
    } else {
      err = issue(op, seg, lanes.s[s]);
    }
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // namespace ckpt
