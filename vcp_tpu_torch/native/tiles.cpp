// Conditional-replenishment tile packing (host hot path).
//
// Copy of vcp_tpu/native/tiles.cpp. The GOP encoder uploads only the
// 16x16 macroblock tiles that changed since the previous source frame
// (gop_ops.encode_pchunk_delta). This pass fuses the tile gather, the
// comparison against the carried state and the compaction into one
// cache-friendly sweep, updating the carried state in place; the numpy
// pair gop_ops.tiles_from_planes_host + delta_tiles_host is its plain
// reference. Host code, not a device kernel.
//
// Tile layout matches gop_ops.TILE_WORDS: 256 luma bytes (16 rows of
// 16) + 64 cb + 64 cr, per MB in raster order.
//
// C ABI, loaded via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of changed MBs K; idx_out[0..K) are their indices,
// tiles_out[0..K*384) their packed tiles. prev (nMB*384) is updated in
// place to the current frame's tiles. If full != 0, every MB is treated
// as changed (bootstrap).
int32_t vcp_tile_delta(const uint8_t* y, const uint8_t* u,
                       const uint8_t* v, int32_t h, int32_t w,
                       uint8_t* prev, int32_t* idx_out,
                       uint8_t* tiles_out, int32_t full) {
    const int32_t mby = h / 16, mbx = w / 16;
    const int32_t wc = w / 2;
    int32_t k = 0;
    uint8_t tile[384];
    for (int32_t by = 0; by < mby; by++) {
        for (int32_t bx = 0; bx < mbx; bx++) {
            const int32_t mb = by * mbx + bx;
            uint8_t* t = tile;
            const uint8_t* ysrc = y + (by * 16) * w + bx * 16;
            for (int r = 0; r < 16; r++, ysrc += w, t += 16)
                std::memcpy(t, ysrc, 16);
            const uint8_t* usrc = u + (by * 8) * wc + bx * 8;
            for (int r = 0; r < 8; r++, usrc += wc, t += 8)
                std::memcpy(t, usrc, 8);
            const uint8_t* vsrc = v + (by * 8) * wc + bx * 8;
            for (int r = 0; r < 8; r++, vsrc += wc, t += 8)
                std::memcpy(t, vsrc, 8);
            uint8_t* p = prev + (int64_t)mb * 384;
            if (full || std::memcmp(tile, p, 384) != 0) {
                std::memcpy(p, tile, 384);
                std::memcpy(tiles_out + (int64_t)k * 384, tile, 384);
                idx_out[k++] = mb;
            }
        }
    }
    return k;
}

}  // extern "C"
