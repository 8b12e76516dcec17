// Host-side audio kernels for the data-loading path.
//
// The TPU compute path is JAX/XLA; this small C++ library covers the
// host-side loops that feed the device queue (role of the reference's
// native engines' CPU frontends, SURVEY.md §2.3): PCM conversion, frame
// energy, and the VAD hysteresis state machine, all operating on large
// multi-hour buffers where Python-loop or numpy-temporary overhead
// matters. Built with plain g++ (no pybind11) and bound via ctypes;
// every entry point has a numpy fallback in Python.

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// int16 little-endian PCM → float32 in [-1, 1)
void wj_pcm16_to_f32(const int16_t* in, float* out, int64_t n) {
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = in[i] * scale;
    }
}

// 24-bit packed PCM → float32
void wj_pcm24_to_f32(const uint8_t* in, float* out, int64_t n_frames) {
    const float scale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n_frames; ++i) {
        int32_t v = (int32_t)in[3 * i]
                  | ((int32_t)in[3 * i + 1] << 8)
                  | ((int32_t)in[3 * i + 2] << 16);
        if (v & 0x800000) v -= 0x1000000;
        out[i] = v * scale;
    }
}

// interleaved multichannel float → mono mean
void wj_downmix_mean(const float* in, float* out, int64_t n_frames,
                     int channels) {
    const float inv = 1.0f / channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        const float* p = in + i * channels;
        for (int c = 0; c < channels; ++c) acc += p[c];
        out[i] = acc * inv;
    }
}

// per-frame energy in int16-referenced dB: 10*log10(mean((x*32768)^2))
void wj_frame_energy_db(const float* in, int64_t n, int64_t hop,
                        float* out, int64_t n_frames) {
    for (int64_t f = 0; f < n_frames; ++f) {
        const float* p = in + f * hop;
        double acc = 0.0;
        for (int64_t i = 0; i < hop; ++i) {
            double s = (double)p[i] * 32768.0;
            acc += s * s;
        }
        double mean = acc / (double)hop;
        out[f] = (float)(10.0 * log10(mean + 1e-12));
    }
}

// dual-threshold hysteresis over frame probabilities.
// Writes up to max_regions (start_frame, end_frame) pairs; returns count.
int64_t wj_hysteresis(const float* probs, int64_t n_frames,
                      float onset, float release,
                      int64_t* starts, int64_t* ends,
                      int64_t max_regions) {
    int64_t count = 0;
    bool in_speech = false;
    int64_t start = 0;
    for (int64_t i = 0; i < n_frames; ++i) {
        float p = probs[i];
        if (!in_speech && p >= onset) {
            in_speech = true;
            start = i;
        } else if (in_speech && p < release) {
            in_speech = false;
            if (count < max_regions) {
                starts[count] = start;
                ends[count] = i;
                ++count;
            }
        }
    }
    if (in_speech && count < max_regions) {
        starts[count] = start;
        ends[count] = n_frames;
        ++count;
    }
    return count;
}

}  // extern "C"
