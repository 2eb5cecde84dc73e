// Baseline JPEG decode and encode on the card through nvJPEG.
//
// Host C++ (no kernel of its own): the port's image I/O, the counterpart of
// the reference's host decoders and encoder -- PIL's draft("L") and
// cv2.imread for detection (imageanalysis_tpu/features/detect.py:69-119),
// cv2.imread / cv2.imwrite for the textures of Step 5
// (imageanalysis_tpu/render/build_map.py:107-146) and for the synthetic
// mission's frames (imageanalysis_tpu/testing/synthetic.py:217-228). It
// replaces host library code, not a Pallas kernel.
//
// nvJPEG's default backend decodes the Huffman stream on the host and runs
// dequantisation, the IDCT and the colour conversion on the card, writing
// into a torch tensor on the caller's stream. The encoder runs the whole
// baseline encode on the card; the bitstream is then copied to the host.
//
// One nvJPEG handle for the process; one decoder state and one encoder
// state per thread (nvJPEG's states are not thread-safe), each made at the
// thread's first call and kept for the life of the process.
//
// Every entry point returns 0 on success, a positive nvjpegStatus_t from
// nvJPEG, or the negated cudaError_t of a CUDA call.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <mutex>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_SUCCESS;
std::once_flag g_handle_once;

struct Codec {
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

thread_local Codec t_codec;

int handle(nvjpegHandle_t* out) {
  std::call_once(g_handle_once, [] {
    g_handle_status = nvjpegCreateSimple(&g_handle);
  });
  *out = g_handle;
  return g_handle_status;
}

int decoder(nvjpegHandle_t* h, nvjpegJpegState_t* st) {
  if (int s = handle(h)) return s;
  if (!t_codec.dec) {
    if (int s = nvjpegJpegStateCreate(*h, &t_codec.dec)) return s;
  }
  *st = t_codec.dec;
  return 0;
}

int encoder(nvjpegHandle_t* h, cudaStream_t stream) {
  if (int s = handle(h)) return s;
  if (!t_codec.enc) {
    if (int s = nvjpegEncoderStateCreate(*h, &t_codec.enc, stream)) return s;
  }
  if (!t_codec.params) {
    if (int s = nvjpegEncoderParamsCreate(*h, &t_codec.params, stream)) {
      return s;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// The header of a JPEG in host memory: the number of components and the
// size of component 0 (the full image size).
int jpeg_info(const unsigned char* data, size_t length, int* components,
              int* width, int* height) {
  nvjpegHandle_t h;
  if (int s = handle(&h)) return s;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t subsampling;
  if (int s = nvjpegGetImageInfo(h, data, length, components, &subsampling,
                                 widths, heights)) {
    return s;
  }
  *width = widths[0];
  *height = heights[0];
  return 0;
}

// Decode a JPEG in host memory into out (device memory) on stream:
// bgr = 0 writes the luma (NVJPEG_OUTPUT_Y, one byte a pixel), bgr = 1
// interleaved BGR (NVJPEG_OUTPUT_BGRI, three); pitch is out's row stride in
// bytes. Returns when the host part is done; the card's part runs on stream.
int jpeg_decode(const unsigned char* data, size_t length, int bgr, void* out,
                size_t pitch, void* stream) {
  nvjpegHandle_t h;
  nvjpegJpegState_t st;
  if (int s = decoder(&h, &st)) return s;
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = pitch;
  return nvjpegDecode(h, st, data, length,
                      bgr ? NVJPEG_OUTPUT_BGRI : NVJPEG_OUTPUT_Y, &img,
                      static_cast<cudaStream_t>(stream));
}

// Encode interleaved BGR bytes (device memory, row stride pitch) as a
// baseline JPEG at quality, 4:2:0 chroma, standard Huffman tables (what
// cv2.imwrite writes by default). Waits for the stream, then leaves the
// bitstream in this thread's encoder state and its size in *length, for
// jpeg_encode_fetch.
int jpeg_encode(const void* bgr, int width, int height, size_t pitch,
                int quality, void* stream, size_t* length) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegHandle_t h;
  if (int e = encoder(&h, s)) return e;
  if (int e = nvjpegEncoderParamsSetQuality(t_codec.params, quality, s)) {
    return e;
  }
  if (int e = nvjpegEncoderParamsSetSamplingFactors(t_codec.params,
                                                    NVJPEG_CSS_420, s)) {
    return e;
  }
  if (int e = nvjpegEncoderParamsSetOptimizedHuffman(t_codec.params, 0, s)) {
    return e;
  }
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(const_cast<void*>(bgr));
  img.pitch[0] = pitch;
  if (int e = nvjpegEncodeImage(h, t_codec.enc, t_codec.params, &img,
                                NVJPEG_INPUT_BGRI, width, height, s)) {
    return e;
  }
  if (int e = nvjpegEncodeRetrieveBitstream(h, t_codec.enc, nullptr, length,
                                            s)) {
    return e;
  }
  cudaError_t c = cudaStreamSynchronize(s);
  return c == cudaSuccess ? 0 : -static_cast<int>(c);
}

// Copy the bitstream of this thread's last jpeg_encode into out (host
// memory of *length bytes, as jpeg_encode reported).
int jpeg_encode_fetch(unsigned char* out, size_t* length, void* stream) {
  nvjpegHandle_t h;
  if (int s = handle(&h)) return s;
  if (!t_codec.enc) return NVJPEG_STATUS_NOT_INITIALIZED;
  return nvjpegEncodeRetrieveBitstream(h, t_codec.enc, out, length,
                                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
