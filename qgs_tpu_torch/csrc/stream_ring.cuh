// A warp's ring of entry records in shared memory, filled from device
// memory ahead of the warp's walks over its group's list.  Used by the
// streamed RK4 kernels (rk4_streamed.cu, rk4_df_streamed.cu), which keep
// the records of a tensor too large for one block's shared memory in
// device memory (where every block reads the same list, so it stays in
// the 50 MB L2).
//
// A group's list is the 16-byte records of
// qgs_tpu_torch.ops.fused_rk4.group_layout, padded with zero records to
// whole tiles of kTile records (qgs_tpu_torch.ops.fused_rk4.
// streamed_records).  A walk of a list of len records reads them in
// order, two at a time (one chunk), plus the one zero chunk past the end
// that the kernels read ahead: positions 0 .. len + 1, so a walk covers
// tiles = ceil((len + kAhead) / kTile) tiles and never reads past them.
// The warp walks the same list four times a step, so the tiles it reads
// form a periodic stream; the ring holds kSlots consecutive tiles of that
// stream.  When the warp moves on to the next tile, the slot it leaves is
// refilled with the tile kSlots ahead: every lane starts one 16-byte
// cp.async of its record, one commit group a tile; before reading a slot
// the warp waits for that slot's group and syncs, so that every lane sees
// every record.  Every lane reads the same record (a broadcast load).  A
// tile is 512 bytes; at the resident kernels' pace (about 100 cycles a
// chunk, 16 chunks a tile) the ring's kSlots - 1 tiles in flight cover
// several thousand cycles of L2 latency.  (A TMA bulk copy of the whole
// tile, completing on an mbarrier a slot, was measured against this on the
// H100 and was as fast or slower on every shape: PERF.md, Findings.)

#pragma once

#include <cuda_runtime.h>

namespace qgs_ring {

constexpr int kTile = 32;       // records a slot: one 16-byte record a lane
constexpr int kSlots = 4;       // slots a warp
constexpr int kAhead = 2;       // records read past a list's end (a chunk)
constexpr int kTileBytes = kTile * 16;

// Shared memory of the rings of `groups` warps.
__host__ __device__ constexpr size_t ring_bytes(int groups) {
  return (size_t)groups * kSlots * kTileBytes;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

struct Ring {
  const int4* src;            // the warp's list in device memory
  int4* slots;                // kSlots tiles
  int tiles;                  // tiles a walk
  int lane;
  int slot;                   // the slot being read
  int off;                    // the next record to read in it
  int next;                   // the list tile that the next fill copies

  __device__ __forceinline__ Ring(const int4* list, int len, int4* ring,
                                  int t)
      : src(list), slots(ring),
        tiles((len + kAhead + kTile - 1) / kTile), lane(t), slot(0),
        off(0), next(0) {}

  __device__ __forceinline__ void fill(int s, int tile) {
    const int4* from = src + (size_t)tile * kTile;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_addr(slots + s * kTile + lane)),
                    "l"(from + lane) : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // Wait until the oldest of the kSlots groups in flight, the slot about
  // to be read, has landed, and every lane sees it.
  __device__ __forceinline__ void wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(kSlots - 1) : "memory");
    __syncwarp();
  }

  // After the block's first barrier: fill every slot, wait for the first.
  __device__ __forceinline__ void start() {
    for (int s = 0; s < kSlots; ++s) fill(s, s % tiles);
    next = kSlots % tiles;
    wait();
  }

  // Leave the current slot (refilled with the tile kSlots ahead of it) for
  // the next one.
  __device__ __forceinline__ void advance() {
    __syncwarp();                 // every lane's reads of the slot are done
    fill(slot, next);
    next = next + 1 == tiles ? 0 : next + 1;
    if (++slot == kSlots) slot = 0;
    off = 0;
    wait();
  }

  // The next chunk's two records (the same for every lane).
  __device__ __forceinline__ void read(int4& a, int4& b) {
    if (off == kTile) advance();
    const int4* p = slots + slot * kTile + off;
    a = p[0];
    b = p[1];
    off += 2;
  }

  // The walk is over: the next read starts the next walk's first tile.
  __device__ __forceinline__ void end_walk() { off = kTile; }

  // Before the block exits: wait for the fills still in flight.
  __device__ __forceinline__ void drain() {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
};

}  // namespace qgs_ring
