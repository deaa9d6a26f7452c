// Standalone native vocoder CLI (capability parity with the reference's
// `vocoder -w weights.bin -m mel.npy` tool, ref:
// runtimeracer_version/src/vocoder.cpp:40-107).
//
// Input mel is a raw little-endian float32 file with a 2×int32 header
// (n_mels, n_frames); output is raw float32 samples.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "wavernn_engine.h"

int main(int argc, char** argv) {
  std::string weights, mel_path, out_path = "wavout.raw";
  uint64_t seed = 1337;
  bool argmax = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "-w" && i + 1 < argc) weights = argv[++i];
    else if (a == "-m" && i + 1 < argc) mel_path = argv[++i];
    else if (a == "-o" && i + 1 < argc) out_path = argv[++i];
    else if (a == "-s" && i + 1 < argc) seed = strtoull(argv[++i], nullptr, 10);
    else if (a == "--argmax") argmax = true;
    else {
      fprintf(stderr,
              "usage: %s -w weights.bin -m mel.raw [-o out.raw] [-s seed] "
              "[--argmax]\n",
              argv[0]);
      return 2;
    }
  }
  if (weights.empty() || mel_path.empty()) {
    fprintf(stderr, "missing -w or -m\n");
    return 2;
  }

  rtvc::Model model;
  std::string err;
  if (!model.load(weights, &err)) {
    fprintf(stderr, "load failed: %s\n", err.c_str());
    return 1;
  }
  model.set_seed(seed);

  FILE* f = fopen(mel_path.c_str(), "rb");
  if (!f) {
    fprintf(stderr, "cannot open %s\n", mel_path.c_str());
    return 1;
  }
  int32_t n_mels = 0, n_frames = 0;
  if (fread(&n_mels, 4, 1, f) != 1 || fread(&n_frames, 4, 1, f) != 1) {
    fprintf(stderr, "bad mel header\n");
    fclose(f);
    return 1;
  }
  std::vector<float> mel((size_t)n_mels * n_frames);
  if (fread(mel.data(), sizeof(float), mel.size(), f) != mel.size()) {
    fprintf(stderr, "truncated mel\n");
    fclose(f);
    return 1;
  }
  fclose(f);

  std::vector<float> wav = model.generate(mel.data(), n_frames, argmax);
  FILE* out = fopen(out_path.c_str(), "wb");
  fwrite(wav.data(), sizeof(float), wav.size(), out);
  fclose(out);
  printf("wrote %zu samples to %s\n", wav.size(), out_path.c_str());
  return 0;
}
