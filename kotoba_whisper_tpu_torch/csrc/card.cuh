// The card a host entry launches on, and its per-card set-up. A kernel's
// dynamic shared-memory opt-in (cudaFuncSetAttribute), a card's SM count
// and a grid sized by occupancy hold for one card only, so every host entry
// keeps them in a table indexed by the card, kMaxCards slots, never in a
// scalar static. Each entry takes the index of the card its tensors are on
// as its first argument (the wrappers pass `tensor.get_device()`) and opens
// a CardScope on it before it touches that table or launches.
#pragma once

#include <cuda_runtime.h>

namespace kwt_card {

constexpr int kMaxCards = 64;  // cards a host entry keeps set-up state for

// Makes `card` the current device for one host entry and gives the
// caller's device back on exit. cudaSetDevice runs only where the two
// differ, so a process on one card pays one cudaGetDevice a call.
class CardScope {
 public:
  explicit CardScope(int card) : card_(card) {
    if (card < 0 || card >= kMaxCards) {
      err_ = cudaErrorInvalidDevice;
      return;
    }
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != card) err_ = cudaSetDevice(card);
  }
  ~CardScope() {
    if (err_ == cudaSuccess && prev_ != card_) cudaSetDevice(prev_);
  }
  CardScope(const CardScope&) = delete;
  CardScope& operator=(const CardScope&) = delete;
  // cudaSuccess (0), or why the card could not be entered.
  int error() const { return static_cast<int>(err_); }

 private:
  int card_, prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace kwt_card
