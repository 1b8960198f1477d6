#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mlx_video_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
2. build: compiles the CUDA kernels from mlx_video_tpu_torch/csrc with nvcc,
   one process per source.
3. K1 vs plain: the flash-attention kernel against its plain fp32 version in
   bf16 at H=32, D=128, (B, S) = (1, 320) and (1, 1280) (the distilled
   path's shapes), (2, 320) and (2, 1280) (two videos in a batch; stage-2
   CFG), (1, 3456) (the training shape), (1, 1000) (ragged),
   (1, 5184) and (2, 5184) (the dev path's with the routes off), plus (1,
   1280) at D=64 and the AV paths' audio self-attention at D=64: (1, 34),
   (2, 34) (the AudioOnly DiT under audio CFG), (2, 68), (2, 1) and (1, 67)
   (the AV LoRA step's 67 audio tokens, AV_TRAIN_T, with its lse). Every
   shape is checked with its lse: max |d o| <= 2e-2, relative L2 of o <=
   4e-3 (bf16 rounding of P and of o reads about 2.4e-3; one key tile's P V
   left out reads 0.16 at S=5184) and max |d lse| <= 1e-3;
   every shape is printed before a failure ends the phase. Median times of
   both and of F.scaled_dot_product_attention's forward (a yardstick, never
   on the path) from CUDA events after warm-up, K1's share of its bound and
   its time as a multiple of SDPA's.
4. K2 vs plain: the dequantizing matmul against its plain version (the same
   bf16 weights, dequantized, then a matmul) at the q4 paths' shapes, M in
   (128, 320, 1280) (inference) and 3456 (a LoRA step's video rows) x (K, N)
   in ((4096, 4096), (4096, 16384), (16384, 4096)), (1024, 4096, 4096)
   (a LoRA step's caption rows), and the AV path's (34, 2048, 2048), (34,
   2048, 8192), (34, 8192, 2048) (audio rows; 68 rows at B = 2 under audio
   CFG), (128, 2048, 2048) and (256, 2048, 2048) (audio caption rows, B = 1
   and 2), (320 and 1280, 4096, 2048) and (320 and 1280, 2048, 4096) (the
   cross-modal projections of the video rows), the AV LoRA step's (67,
   2048, 2048), (67, 2048, 8192), (67, 8192, 2048) (its audio rows), (3456,
   4096, 2048), (3456, 2048, 4096) (the cross-modal projections of its video
   rows) and (1024, 2048, 2048) (its audio caption rows), bits 4, group 64, plus bits
   8 / group 128, bits 2 / group 32,
   bits 4 / group 16, a ragged M = 300 and bf16 and fp16 scales: max |d y|
   <= 1e-2 max |y| and relative L2 <= 1e-3 (only the summation order and
   the bf16 rounding of y differ). The control, at every case with fp32
   scales: the plain version on bf16-rounded scales and biases (the Pallas
   kernel's rounding) must fail the L2 bar. Two calls must give bitwise-equal
   y at every case (splits of K add in a fixed order). Median times of the
   kernel (with fp32 scales, the dtype the q4 run's quantization gives, and
   again with bf16 scales, the dtype of MLX's own snapshots), the plain
   version and dense cuBLAS on the dequantized bf16 weight, each launch
   after an L2 flush, and the kernel's share of its bound.
5. K3 vs plain: the flash backward against its plain fp32 version on the same
   bf16 inputs (q, k, v, dO random, o and lse from K1) at B=1, H=32, D=128,
   S = 1280, 3456 (the training shape), 1000 (ragged) and 5184, plus D=64 at
   S = 1280 and 67 (the AV LoRA step's audio tokens: under one 128-key dkv
   block and ragged): per gradient relative L2 <= 5e-3 and max |d| <= 2e-2 max |ref| (the
   kernel rounds p and dS to bf16 before their products, as the Pallas
   kernels do, and its outputs to bf16: ~2^-9 relative each), every shape
   printed before a failure ends the phase; two runs must give bitwise-equal
   gradients (no atomics). Median times of K3, the plain
   version and the backward of F.scaled_dot_product_attention (a yardstick),
   K3's share of its bound and its time as a multiple of SDPA's backward, and
   the device time a call of its dq and dkv kernels (torch.profiler): the
   event time less their sum is the host work a call exposes.
5a. K4 vs plain: the text cross-attention kernel against its plain version
   (fp32 logits and softmax, probabilities in bf16 for the second product) in
   bf16 at H=32, D=128: (B, Sq, Skv) = (2, 5184, 128) (the dev path's, batched
   CFG, no mask), (1, 3456, 1024) with 128 real keys (the trainer's), a ragged
   Skv = 77, a batch row whose keys are all masked (it must be the mean of v)
   and two rows with different masks; then the AV dev path's at D=64: (2, 68,
   128) (audio text attention), (2, 5184, 68) (audio-to-video, the resident
   kernel) and (2, 68, 5184) (video-to-audio, the streamed kernel):
   max |d o| <= 2e-2 (K1's bar), every
   case printed before a failure ends the phase. Median
   times of K4, the plain version and F.scaled_dot_product_attention with the
   additive mask (a yardstick, never on the path), K4's share of its bound
   and its time as a multiple of SDPA's; the device time a call of K4's
   kernel and of SDPA's (torch.profiler), and K4's host time a call (the
   enqueue of 50 calls back to back).
5b. K5 vs plain: flash attention with split RoPE (a rotation pass, then K1's
   kernel) against its plain version (q and k rotated in fp32 and cast back,
   exact attention) at (B, S) = (2, 5184) (the dev path's), (1, 3456) and
   (1, 1280), with the DiT's tables, and (2, 68) at D=64 with the audio
   stream's tables (the AV dev path's audio self-attention): K1's bars. Bitwise, with the elements
   that differ printed (every shape before a failure ends the phase): the rotation pass against rotate_split, K5 against
   K1 on the plainly rotated q and k (o and lse), and K5 against itself on
   those under identity tables (cos = 1, sin = 0). Median times of K5, of its
   rotation pass alone, of K1 on the rotated q and k, of the plain version,
   of "K1 + torch rotation" (the unfused route) and of SDPA's forward on the
   rotated q and k, K5's share of its
   bound, the device time a call of its two kernels and its host time a
   call. Then the K5 Function's gradients (K3 on the rotated inputs,
   rotated back) against plain autograd at S = 1280: K3's bars.
5c. K6 vs plain: the int8 attention against its plain version (the same
   quantization prologue, exact integer products) in bf16 at H=32, D=128,
   (B, S) = (1, 320) and (1, 1280) (the distilled stages), (2, 5184) (config
   3, batched CFG), (1, 1000) (ragged; 8 of its heads have only negative
   logits), plus (1, 1280) at D=64: max |d o| <= 2e-2 and relative L2 <=
   1e-3, with the p_q codes that differ counted (at most 1e-4 of them);
   against K1 on the same bf16 inputs relative L2 < 5e-2 (the quantization
   error by design, the JAX test's bar). At every shape the CUDA prologue's
   operands must equal the plain prologue's bit for bit (torch.equal, every
   field), and two calls must give the same output and codes. Median times
   of K6 alone, of the CUDA and the plain prologue (the CUDA one's device
   time too, torch.profiler), of the whole call, of the plain version, of K1
   and of SDPA's bf16 forward (the last two compute another function:
   yardsticks); K6's share of its int8 bound and the MUFU floor of its
   exponentials, S^2 H B / (16 x SMs x the card's maximum SM clock).
6. small slices vs reference: a 2-layer DiT denoise (2 steps at 320 tokens),
   upsampler and decoder at narrow width, bf16 on the card against fp32 on
   the CPU (plain attention, plain dequantizing matmul) with the same
   weights and inputs, dense and with the DiT quantized to 4 bits: per-frame
   PSNR >= 35 dB, the repo's pipeline gate. Then one LoRA training step
   (rank 8, non-zero B, gradient checkpointing, 320 tokens, first-frame
   conditioning on, a drawn sigma) on a 2-layer DiT of that width: the
   trainer's grad_step in bf16 on the card against fp32 on the CPU with the
   same weights and draws. The bf16 model rounds sigma, then 1000 * sigma, to
   bf16 (as the JAX package does), so the fp32 reference is given those
   rounded timesteps. Bars: relative difference of the loss <= 1e-2 and
   relative L2 of every LoRA gradient <= 5e-2 (bf16 on the CPU reads ~1.5e-2
   against fp32 there, and tens of percent against fp32 on the exact
   timesteps: tests/test_torch_port_train.py
   ::test_bf16_lora_gap_is_the_timestep_rounding). Then the dev pipeline at
   narrow width with the K4 and K5 routes on: that 2-layer DiT, a narrow VAE
   encoder and decoder, one seeded PNG at frame 0 (strength 1), batched CFG
   4.5, 2 steps at 256x256x17; per-frame PSNR >= 35 dB of latents and RGB.
6a. int8 slices at narrow width: the 2-layer DiT in W8A8 and in W4A8 through
   the distilled slice of phase 6 (the same int8 codes on both sides), >= 35
   dB per frame; a tiny Gemma-3 (4 layers of 256, a sliding window and global
   layers) with the connectors, bf16 on the card against fp32 on the CPU on
   64 left-padded token ids: relative L2 <= 2e-2; in W8A8 <= 2e-2 against the
   CPU's W8A8 in bf16, and <= 4e-2 against its W8A8 in fp32 (bf16-rounded
   activations move about a quarter of their int8 codes by one step: the CPU
   reads 2.2e-2 to 2.8e-2 bf16 against fp32 there); one LoRA step over a
   W4A8 base with phase 6's LoRA-step bars.
6b. audio at narrow width: a 2-layer AudioVideo DiT (video 4 x 128 heads,
   audio 4 x 64) through 2 joint distilled steps at 320 video tokens and 34
   audio frames, bf16 on the card (8 K1) against fp32 on the CPU: >= 35 dB
   per video latent frame and over the audio latents; a narrow audio VAE
   decoder (ch 32) and vocoder (128 channels) on those frames, on the card
   as generate_video runs them (fp32 latents into the bf16 weights: the
   convolutions run in fp32), with cuDNN's TF32 off and on, against fp32 on
   the CPU: waveform SNR >= AUDIO_SNR_BAR_DB (37 dB, set from the card's
   41.64 and 41.60 dB on an H100, PERF.md §6); one AV LoRA step on that
   DiT (adapters on the 28 linears of a block, 67 audio frames), bf16 on the
   card against fp32 on the CPU on the same draws, the audio noise included,
   the reference on the bf16-rounded timesteps of both streams, with phase
   6's LoRA-step bars.
7. full-width dense slice: generate_video, distilled, 512x512x33, on
   synthetic bf16 weights of the 19B video DiT geometry (48 layers, 32x128
   heads), the default VAE decoder and the 1024-channel upsampler, all drawn
   on the card from a seeded generator. Checks a finite (1, 3, 33, 512, 512)
   video and 48 x (8 + 3) = 528 K1 launches; then one warm run under
   torch.profiler (idle share, time by kernel class).
7a. full-width dev slice (BASELINE.md config 3): generate_video, dev, on the
   same DiT with the default VAE encoder (seeded, bf16), 768x768x65 (5184
   tokens), 40 steps of ltx2_scheduler, CFG 4.5 batched, one seeded 768x768
   PNG (written with cv2) at frame 0 with strength 1, 128-token positive and
   negative embeddings, MLX_VIDEO_TPU_CROSS_KERNEL and MLX_VIDEO_TPU_FUSED_ROPE
   on. Checks exactly 40 x 48 = 1920 K4 and 1920 K5 launches and no K1, a
   finite (1, 3, 65, 768, 768) video and latent frame 0 equal to the encoded
   image (to 2^-8 of its largest value). Then, on the same seed and latents
   only: 2 steps with the routes on against off (96 K1 launches, plain
   cross-attention), each under torch.profiler (idle share, device time by
   kernel class; for the routes off K1's share of it and the step seconds),
   per-frame latent PSNR >= 35 dB; the dev_denoise seconds a step of both,
   without the profiler, 2 steps each in turns (off, on, on, off); and one
   step of sequential against batched CFG (96 K4 and 96 K5 launches), the
   same bar. The routes are off again
   for the phases below; the encoder stays for phases 11 and 10.
11. full-width conditioned distilled slice: generate_video at 512x512x33
   (stage 1 at 320 tokens, stage 2 at 1280), 8 + 3 steps, on the same DiT,
   encoder, decoder and upsampler and the 128-token embeddings. Every run
   checks a finite video of the full shape (two where there are two) and its
   K1 launches, and prints its phase seconds and peak device memory:
   (a) one seeded 512x512 PNG at frame 0, replace mode: 528 K1, latent frame
   0 equal to the encoded image to 2^-8 of its largest value; (b) the
   keyframe pipeline, PNGs at media frames 0 and 32 (latent 0 and 4), guide
   mode, streamed: 528 K1, the writer gets all 33 frames in more than one
   piece and they equal frames_to_uint8 of the returned video bit for bit;
   the same seed unstreamed gives bitwise-equal latents (its per-frame RGB
   PSNR against the streamed video, whose decode is tiled, is printed
   without a bar: on seeded weights a tiled decode is 18-30 dB from an
   untiled one, in the JAX package too); then the streamed latents decoded
   with the device blend against the host blend on the same tiles and
   decode noise, max |d| <= 1e-6; (c) a seeded rank-32 adapter in
   the reference format on the ltx2_ic_lora_v2v.yaml recipe (to_q, to_k,
   to_v, to_out.0 of attn1 and attn2 in 48 blocks: 384 pairs), merged by
   merge_lora_into_params (applied=384 skipped=0, its seconds and memory),
   two merged linears against a CPU merge of the same bf16 tensors (at most
   1e-4 of the elements one bf16 ulp apart), then the IC-LoRA pipeline on a
   seeded 33-frame clip (cv2, mp4v) at frame 0: 528 K1, the base's two
   linears unchanged; (f) num_videos=2 at seeds 35 and 36: 528 K1 at B = 2,
   two mp4s, each video's latents >= 35 dB per frame against its single run
   (528 K1 each); (d) stage 2 on the merged DiT of (c), stage 1 on the
   base: 528 K1, latents that differ from the seed-35 single run; (e)
   stage-2 CFG 4.0 on seeded negative embeddings, batched (528 K1) and
   sequential (48 x 8 + 2 x 48 x 3 = 672 K1), >= 35 dB per latent frame
   apart. The merged copy is freed at the end.
12. full-width audio slice: the 19B AudioVideo DiT (18.88 B params: the
   phase-7 video DiT's modules, shared, plus 5.83 B seeded audio and
   cross-modal params, 32 x 64 audio heads), the AudioOnly DiT on its audio
   modules, the default audio VAE decoder and vocoder (seeded bf16), seeded
   128-token audio and negative embeddings. Every run checks its exact
   launches, finite video and audio latents of the full shape, a finite (2,
   240 (4T - 3)) waveform, a 24 kHz 2-channel WAV of that length, an mp4
   (with an audio stream where ffmpeg exists; the machine's ffmpeg is
   printed), phase seconds and peak memory: (a) joint distilled 512x512x33
   (T = 34), 8 + 3 steps: 1056 K1, then a warm run under torch.profiler and
   a profile of decode_audio alone on its latents; (b) separate, the
   AudioOnly DiT 8 steps at B = 2 (audio CFG): 912 K1, audio_denoise seconds;
   (c) joint dev 768x768x65 (T = 68), 40 steps, CFG 4.5, one image, both
   routes on: 3840 K5, 7680 K4, 0 K1, latent frame 0 equal to the encoded
   image; then 2 steps with the routes on against off and 1 step of
   sequential against batched CFG: >= 35 dB per video latent frame and over
   the audio latents. The audio tensors are freed at the end. Every K1 and
   K2 launch of (a)-(d) is at a shape that phase 3 or 4 compared with the
   plain version (their (B, S, H, D) and (M, K, N, bits, group) are
   recorded at the C entry; any other fails the phase).
8. full-width dense LoRA training: the Trainer (the ltx2_lora.yaml recipe:
   rank 8, alpha 16, lr 1e-4 cosine, shifted-logit-normal timesteps,
   first-frame conditioning p 0.1, max_grad_norm 1, batch 1) with gradient
   checkpointing on the same bf16 DiT, over a seeded PrecomputedDataset of 2
   clips at 768x512x65 (latents (128, 9, 16, 24): 3456 tokens; 1024 caption
   tokens of which 128 are real): 4 steps, saves every 2. Checks finite
   losses, LoRA B norms that moved, exactly 2 x 48 = 96 K1 and 48 K3
   launches a step, the adapter's reference keys; then a fresh Trainer
   resumes from state_step_2 and must repeat the losses of steps 2 and 3
   exactly. Prints step seconds, tokens per second and peak device memory.
   Then one more warm step of the resumed Trainer (forward, recompute,
   backward, AdamW) under torch.profiler, outside the counted run: 96 K1 and
   48 K3 launches; idle share and the K3, K1, GEMM and elementwise shares of
   device time. The adapters are then taken off the model.
9a. full-width W8A8 slice: a W8A8 copy of the same bf16 DiT (the block
   linears as Int8Linears, the rest shared), the distilled run of phase 7:
   528 K1, 0 K2 and 10 x 48 x 11 = 5280 int8 products, a finite video; then
   one warm run under torch.profiler (idle share, time by kernel class). The
   q, k and v of the 48 attn1 calls of the first stage-2 step (1280 tokens)
   are recorded, and K6 and K1 run on each: K6's launches and its CUDA
   prologue's on the path (48 each) and their relative L2; K6 against its
   plain version, and its CUDA prologue bitwise against the plain one, on
   the first.
9b. full-width text encoder: the Gemma-3-12B geometry (48 layers of 3840,
   16 x 256 heads with 8 KV heads, FFN 15360, vocab 262208) and the
   connectors, seeded bf16 on the card; 1024 left-padded token ids, 128 of
   them real, through encode_tokens: finite (1, 1024, 3840) video and audio
   embeddings, the DiT's caption shape; they drive one distilled run to an
   mp4 (528 K1). Then the encoder in W8A8 in place on the same ids (337 int8
   products an encode): relative L2 against bf16; encode seconds and peak
   memory of both, and a warm encode of each under torch.profiler.
9. full-width q4 slice: the same DiT quantized in place on the card
   (quantize_dit_params, 4 bits, group 64, core scope: 10 linears a block),
   then the same run: 528 K1 and 10 x 48 x 11 = 5280 K2 launches, and a
   warm run of it under torch.profiler (idle share, K2's device time and
   share of busy time, the GEMM and elementwise classes). Then W4A8
   (quantize_models --w4a8 on it: prepare_w4a8, no K2): 528 K1, 0 K2 and
   5280 int8 products, then a warm run under torch.profiler; the int8 scales
   are then taken off.
10. loaders and CLIs: the q4 DiT written as an MLX pre-quantized snapshot
   (ltx-2-19b-distilled-4bit-mlx.safetensors: sanitized keys, uint32
   words under .weight, .scales, .biases), with the decoder, the upsampler
   and an embeddings file, in a temporary directory; load_model_bundle must
   give tensors equal to the in-memory ones, and the CLI's main (--device
   cuda) must run from that directory with 528 K1 and 5280 K2 launches and
   write its output, and again with --w4a8: 528 K1, 0 K2 and 5280 int8
   products. The snapshot's VAE file carries the seeded encoder too (the
   loaded one must equal it), and phase 11's (g) runs the CLI with
   --pipeline keyframe, phase 11's two images at frames 0 and 32,
   --stage2-model-repo on the same snapshot (a second 4-bit DiT), --stream
   and --lora with (c)'s adapter: "[LoRA] ... applied=0 skipped=384" (a
   4-bit base is skipped, as in the JAX package), 528 K1 and 5280 K2 (3840
   on the stage-1 model, 1440 on the stage-2 one) and an mp4. The
   snapshot's DiT file is an AudioVideo one (phase 12's audio tensors drawn
   again on the q4 video modules, their 18 linears a block quantized in the
   core scope: 28 x 48 QuantLinears), with audio_vae/ and vocoder/ beside
   it; load_model_bundle(audio=True, audio_mode="joint") must give it back
   bit for bit, and phase 12 (d) runs the CLI with --audio --audio-mode
   joint (1056 K1, 28 x 48 x 11 = 14784 K2) and with --audio and
   --audio-model-repo at a directory whose ltx-2-19b-distilled-mlx.safetensors
   is that file (separate: 912 K1, 5280 + 10 x 48 x 8 = 9120 K2), each with
   its WAV and mp4. Then the training CLI (cli.train.main, --device cuda)
   trains LoRA for 2 steps over the 4-bit file of the snapshot on the
   dataset of phase 8, with gradient checkpointing: 96 K1, 48 K3 and
   10 x 48 x 2 = 960 K2 launches a step, and lora_step_2.safetensors
   written; then phase 13 (c). Every K1, K3 and K2 launch of both training
   CLI runs is at a shape that phases 3-5 compared. The directories are
   removed at the end.
13. training data and audio-video training, in three parts. (a) runs inside
   phase 9b, on its bf16 text encoder before the W8A8 step: first a narrow
   check, precompute_dataset on one 96x64x9 clip with a narrow video
   encoder, a narrow audio encoder and phase 6a's tiny Gemma-3, bf16 on the
   card against fp32 on the CPU (video, reference and audio latents >= 35 dB
   per latent frame, embeddings relative L2 <= 2e-2); then precompute_dataset
   at full width on 2 seeded 65-frame 832x544 clips (cv2, mp4v) bucketed by
   parse_buckets("768x512x65"): the seeded default video encoder of phase 7a,
   the 12B encoder on 1024 left-padded seeded token ids (128 real), the
   default audio VAE encoder (seeded bf16) on a seeded 2-channel 16 kHz
   waveform of each clip's 43,333 samples (the card machine has no ffmpeg),
   Canny edge references. Every clip must have latents (128, 9, 16, 24),
   reference latents of that shape, conditions (1024, 3840) video and audio,
   and audio latents (8, 67, 16) with num_time_steps 67, all finite; prints
   seconds a clip and peak memory. (b) runs after phase 9b, before phase 9
   quantizes the DiT: the AudioVideo DiT (phase 12's audio tensors drawn
   again on the bf16 video modules) trains LoRA on the ltx2_av_lora.yaml
   recipe (rank 16, alpha 32, lr 5e-5) with gradient checkpointing over
   (a)'s files, 4 steps, saves every 2, and a ValidationSampler (512x512x33,
   8 + 3 steps, (a)'s first caption) at step 0 and after step 2: exactly
   4 x 192 K1 and 4 x 96 K3 in training and 528 K1 a validation call, a
   non-empty mp4 each, finite losses, video and audio LoRA B norms that
   moved, the 2688 reference keys of the adapter (28 linears a block);
   every K1 and K3 launch at a shape phases 3 and 5 compared; then a fresh
   Trainer without validation resumes from state_step_2 and must repeat the
   losses of steps 2 and 3 bit for bit; then one warm step under
   torch.profiler (idle share; K1, K3, GEMM and elementwise shares; step
   seconds; tokens a second; peak memory). (c) in phase 10, the training
   CLI --with-audio over the snapshot's 4-bit AudioVideo file on (a)'s
   files: 2 steps, 192 K1, 96 K3 and 28 x 48 x 2 = 2688 K2 a step, and
   lora_step_2.safetensors written.
Phases 7-13 print phase times and peak device memory. Every profile records
the CUDA activity alone (host op events slow the host side and, past
~140,000 launches, take minutes to aggregate). The order on the card:
1-7a, 11, 12, 8, 9a, 9b with 13 (a), 13 (b), 9, 10 with 13 (c). Last: the
kernel summary line (K1-K6: launches on a path of this run, error against
the plain version, times at the path's shapes, the bound, the library
yardstick; K1, K2, K3, K4 and K5 also their launches on every path of phases
7a-13, "path_launches") and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

# Phase 13's clips: 65 frames at 832x544 (the 768x512x65 bucket crops them),
# each with a 2-channel 16 kHz waveform of its 2.708 s
AV_CLIP_FRAMES, AV_CLIP_SIZE, AV_SAMPLE_RATE = 65, (832, 544), 16000
AV_CLIP_SAMPLES = int(AV_CLIP_FRAMES / 24.0 * AV_SAMPLE_RATE)


def audio_latent_frames(samples: int) -> int:
    """Latent frames the default audio VAE gives a 16 kHz waveform: log-mel
    frames (n_fft 1024, hop 160, not centred), then two causal stride-2
    downsamples. Phase 13 (a) checks its files against it."""
    t = 1 + (samples - 1024) // 160
    for _ in range(2):
        t = (t - 1) // 2 + 1
    return t


AV_TRAIN_T = audio_latent_frames(AV_CLIP_SAMPLES)  # 67: the audio tokens of an AV LoRA step

# (M, K, N) of the 4-bit linears: the q4 inference path's video rows, then
# the LoRA step's (3456 video rows through attn1, attn2 q/out and ff; 1024
# caption rows through attn2 to_k/to_v), then the AV paths': 34 audio rows
# (68 at B = 2 under audio CFG) through the audio linears (2048 wide, FFN
# 8192), 128 caption rows (256 at B = 2) through the audio attn2 to_k/to_v,
# and 320 and 1280 video rows through the cross-modal q, k, v (4096 -> 2048)
# and out (2048 -> 4096), then the AV LoRA step's: AV_TRAIN_T audio rows, the
# cross-modal projections of its 3456 video rows, its 1024 audio caption rows
SHAPES_K2 = [(m, k, n) for m in (128, 320, 1280, 3456) for k, n in ((4096, 4096), (4096, 16384), (16384, 4096))] + [
    (1024, 4096, 4096)] + [(m, k, n) for m in (34, 68, AV_TRAIN_T) for k, n in (
        (2048, 2048), (2048, 8192), (8192, 2048))] + [
    (128, 2048, 2048), (256, 2048, 2048), (1024, 2048, 2048)] + [
    (m, k, n) for m in (320, 1280, 3456) for k, n in ((4096, 2048), (2048, 4096))]
K2_TRAIN_SHAPE = (3456, 4096, 4096)  # 6 of a block's 10 K2 launches in a LoRA step


def kernel_label(mangled: str) -> str:
    """``flash_fwd_kernel<128>`` from a mangled symbol: the length-prefixed
    identifier that ends in ``kernel``, and its integer template argument."""
    for m in re.finditer(r"(?=(\d+)([a-z]\w*))", mangled):
        ident = m.group(2)[:int(m.group(1))]
        if ident.endswith("kernel"):
            arg = re.match(r"ILi(\d+)E", m.group(2)[len(ident):])
            return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int = 20, warmup: int = 3, before=None) -> float:
    """Median CUDA-event time of ``fn``; ``before`` runs ahead of each timed
    launch, outside the events (an L2 flush)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def host_ms(fn, calls: int = 50) -> float:
    """Host time a call of ``fn``: the wall time to enqueue ``calls`` calls
    back to back, over ``calls``. It is the host's own work as long as the
    device takes longer per call (the host then never waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device time a call of ``fn`` by kernel (``name<D>``), from
    torch.profiler over ``reps`` warm calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+<\d+>)\(", e.key)
            out[m.group(1) if m else e.key[:60]] = e.self_device_time_total / 1e3 / reps
    return out


def psnr(a, b, peak: float) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * float(np.log10(peak * peak / mse))


# K1's cases in phase 3: (B, S, D, timed with lse)
K1_SHAPES = [(1, 320, 128, False), (1, 1280, 128, False), (2, 320, 128, False), (2, 1280, 128, False),
             (1, 3456, 128, True), (1, 1000, 128, True), (1, 5184, 128, True), (2, 5184, 128, False),
             (1, 1280, 64, True), (1, 34, 64, False), (2, 34, 64, False), (2, 68, 64, False), (2, 1, 64, False),
             (1, AV_TRAIN_T, 64, True)]
# K3's cases in phase 5: (S, D) at B = 1, H = 32
K3_SHAPES = [(1280, 128), (3456, 128), (1000, 128), (5184, 128), (1280, 64), (AV_TRAIN_T, 64)]
K1_REL_L2 = 4e-3


def kernel_vs_plain(fa) -> dict:
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows, max_o, max_lse, failed = {}, 0.0, 0.0, []
    print(f"K1 vs plain (bf16, H=32; bars max|d o| <= 2e-2, relative L2 of o <= {K1_REL_L2:g}, "
          "max|d lse| <= 1e-3):")
    for b, s, d, with_lse in K1_SHAPES:
        q, k, v = (torch.randn(b, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        out, lse = fa.flash_attention(q, k, v, scale=scale, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_reference(q, k, v, scale, return_lse=True)
        diff = out.float() - ref.float()
        err_o, err_lse = diff.abs().max().item(), (lse - ref_lse).abs().max().item()
        l2 = (diff.norm() / ref.float().norm()).item()
        max_o, max_lse = max(max_o, err_o), max(max_lse, err_lse)
        del diff, lse, ref_lse
        ms = median_ms(lambda: fa.flash_attention(q, k, v, scale=scale, return_lse=with_lse))
        plain_ms = median_ms(lambda: fa.flash_attention_reference(q, k, v, scale, return_lse=with_lse))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale))
        lim = bound(*attention_fwd_work(b, s, 32, d))
        print(f"  B={b} S={s} D={d}: max|d o| {err_o:.3e} (max|ref| {ref.float().abs().max().item():.3e}) "
              f"rel L2 {l2:.3e} max|d lse| {err_lse:.3e}; timed lse={with_lse}: kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  SDPA forward {lib_ms:.4f} ms; {100 * lim['bound_ms'] / ms:.1f} % of the "
              f"{lim['bound_ms']:.4f} ms bound ({lim['bound_by']}), {ms / lib_ms:.2f}x SDPA's time", flush=True)
        if not (err_o <= 2e-2 and l2 <= K1_REL_L2 and err_lse <= 1e-3 and torch.isfinite(out).all()):
            failed.append(f"B={b} S={s} D={d}")
        rows[(b, s, d)] = (ms, plain_ms, lib_ms)
        del q, k, v, out, ref
    if failed:
        fail(f"K1 disagrees with the plain version at {', '.join(failed)}")
    return {"rows": rows, "max_abs_err": max(max_o, max_lse)}


def bwd_kernel_vs_plain(fa) -> dict:
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err, worst_l2, failed = {}, 0.0, 0.0, []
    print("K3 vs plain (bf16, B=1, H=32; bars per gradient: rel L2 <= 5e-3, max|d| <= 2e-2 max|ref|):")
    for s, d in K3_SHAPES:
        q, k, v, do = (torch.randn(1, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
        scale = d**-0.5
        o, lse = fa.flash_attention(q, k, v, scale=scale, return_lse=True)
        args = (q, k, v, o, lse, do, scale)
        got = fa.flash_attention_bwd(*args)
        again = fa.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K3 gradients differ between two runs at S={s} D={d}")
        ref = fa.flash_attention_bwd_reference(*args)
        line = f"  S={s} D={d}:"
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            diff = a.float() - r.float()
            err, l2 = diff.abs().max().item(), (diff.norm() / r.float().norm()).item()
            rel_max = err / r.float().abs().max().item()
            max_err, worst_l2 = max(max_err, err), max(worst_l2, l2)
            line += f" {name} rel L2 {l2:.2e} max|d| {err:.2e} ({rel_max:.2e} of max);"
            if not (l2 <= 5e-3 and rel_max <= 2e-2 and torch.isfinite(a).all()):
                failed.append(f"{name} at S={s} D={d}")
        del ref, again
        ms = median_ms(lambda: fa.flash_attention_bwd(*args))
        plain_ms = median_ms(lambda: fa.flash_attention_bwd_reference(*args), reps=5, warmup=1)
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = do.transpose(1, 2)
        lib_ms = median_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
        lim = bound(*attention_bwd_work(s, 32, d))
        dev = device_ms_by_kernel(lambda: fa.flash_attention_bwd(*args))
        print(line + f" bitwise repeatable; K3 {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"SDPA backward {lib_ms:.4f} ms; {100 * lim['bound_ms'] / ms:.1f} % of the {lim['bound_ms']:.4f} ms "
              f"bound ({lim['bound_by']}), {ms / lib_ms:.2f}x SDPA's backward; device time a call "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
              + f" (sum {sum(dev.values()):.4f} ms)", flush=True)
        rows[(s, d)] = (ms, plain_ms, lib_ms)
        del q, k, v, do, o, lse, args, got, out, qh, kh, vh
    print(f"  K3 worst rel L2 {worst_l2:.3e}; bar 5e-3", flush=True)
    if failed:
        fail(f"K3 disagrees with the plain version: {', '.join(failed)}")
    return {"rows": rows, "max_abs_err": max_err}


def masked_bias(b: int, skv: int, real) -> "torch.Tensor":
    """(B, Skv) fp32 caption-mask bias rows as the DiT makes them,
    (mask - 1) * 1e9 in bf16; row i has ``real[i]`` unmasked keys."""
    import torch

    mask = torch.zeros(b, skv, device="cuda")
    for i, n in enumerate(real):
        mask[i, :n] = 1.0
    return ((mask.to(torch.bfloat16) - 1.0) * 1e9).float()


# K4's cases in phase 5a: (B, Sq, Skv, real keys a row or None, D). The dev
# path's text attention, the trainer's, a ragged Skv, an all-masked row, two
# masks; then the AV dev path's at 32 x 64 heads: audio text attention,
# audio-to-video (resident) and video-to-audio (streamed)
K4_CASES = [(2, 5184, 128, None, 128), (1, 3456, 1024, (128,), 128), (2, 5184, 77, None, 128),
            (2, 5184, 128, (128, 0), 128), (2, 5184, 128, (40, 100), 128),
            (2, 68, 128, None, 64), (2, 5184, 68, None, 64), (2, 68, 5184, None, 64)]


def cross_kernel_vs_plain(ca) -> dict:
    """K4 against its plain version: the dev path's shape (no bias), the
    trainer's 1024 caption keys with 128 real, a ragged Skv, a row whose keys
    are all masked and two rows with different masks. Bar: max |d o| <= 2e-2
    (K1's)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(9)
    rows, max_err, failed = {}, 0.0, []
    print("K4 vs plain (bf16, H=32; bar max|d o| <= 2e-2):")
    for b, sq, skv, real, d in K4_CASES:
        q = torch.randn(b, sq, 32, d, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, skv, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        bias = None if real is None else masked_bias(b, skv, real)
        out = ca.flash_cross_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        ref = ca.flash_cross_attention_reference(q, k, v, bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        line = f"  B={b} Sq={sq} Skv={skv} D={d} real keys {real}: max|d o| {err:.3e}"
        if real is not None and 0 in real:
            row = real.index(0)
            uni = (out[row].float() - v[row].float().mean(0)[None]).abs().max().item()
            line += f", all-masked row vs the mean of v {uni:.3e}"
            if not uni <= 2e-2:
                failed.append(f"the mean of v on the all-masked row at B={b} Sq={sq} Skv={skv}")
        if not (err <= 2e-2 and torch.isfinite(out).all()):
            failed.append(f"the plain version at B={b} Sq={sq} Skv={skv} real={real}")
        if real in (None, (128,)):
            mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
            ms = median_ms(lambda: ca.flash_cross_attention(q, k, v, bias=bias))
            plain_ms = median_ms(lambda: ca.flash_cross_attention_reference(q, k, v, bias=bias))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, scale=d**-0.5))
            rows[(b, sq, skv, d)] = (ms, plain_ms, lib_ms, bias is not None)
            lim = bound(*cross_attention_work(b, sq, skv, 32, d, bias is not None))
            dev = device_ms_by_kernel(lambda: ca.flash_cross_attention(q, k, v, bias=bias))
            host = host_ms(lambda: ca.flash_cross_attention(q, k, v, bias=bias))
            lib_dev = sum(device_ms_by_kernel(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, scale=d**-0.5)).values())
            line += (f"  K4 {ms:.4f} ms  plain {plain_ms:.4f} ms  SDPA with the mask {lib_ms:.4f} ms; "
                     f"{100 * lim['bound_ms'] / ms:.1f} % of the {lim['bound_ms']:.4f} ms bound ({lim['bound_by']}), "
                     f"{ms / lib_ms:.2f}x SDPA's time; device time a call "
                     + ", ".join(f"{n} {t:.4f} ms" for n, t in dev.items())
                     + f", SDPA's kernels {lib_dev:.4f} ms; host time a call {host:.4f} ms")
        print(line, flush=True)
        del q, k, v, out, ref
    if failed:
        fail("K4 disagrees with " + "; ".join(failed))
    return {"rows": rows, "max_abs_err": max_err}


def rope_tables(b: int, f: int, h: int, w: int):
    """The DiT's split-RoPE tables for a (f, h, w) latent grid at the 19B
    geometry: (B, 32, f*h*w, 64) fp32, as precompute_freqs_cis makes them
    (a transposed view for B = 1; concatenated, as batched CFG doubles them,
    for B = 2)."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXRopeType
    from mlx_video_tpu_torch.pipelines.denoise import precompute_video_pe
    from mlx_video_tpu_torch.pipelines.positions import create_position_grid

    config = LTXModelConfig(rope_type=LTXRopeType.SPLIT, double_precision_rope=True)
    cos, sin = precompute_video_pe(config, torch.from_numpy(create_position_grid(1, f, h, w)).cuda())
    if b == 2:
        cos, sin = torch.cat([cos, cos]), torch.cat([sin, sin])
    return cos, sin


def audio_rope_tables(b: int, t: int):
    """The audio stream's split-RoPE tables for T latent frames at the 19B
    geometry: (B, 32, T, 32) fp32, as precompute_audio_pe makes them."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXRopeType
    from mlx_video_tpu_torch.pipelines.denoise import precompute_audio_pe
    from mlx_video_tpu_torch.pipelines.positions import create_audio_position_grid

    config = LTXModelConfig(rope_type=LTXRopeType.SPLIT, double_precision_rope=True)
    return precompute_audio_pe(config, torch.from_numpy(create_audio_position_grid(b, t)).cuda())


def rope_kernel_vs_plain(fa) -> dict:
    """K5 against its plain version (q and k rotated in fp32, cast back, exact
    attention) at the dev path's shape and two more, with K1's bars; its
    rotation pass against the plain rotation, and K5 against K1 on the
    plainly rotated q and k (and against itself there under identity
    tables): the same bits. Then the K5 Function's gradients (K3 on the
    rotated inputs) against plain autograd."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(10)
    rows, max_err, failed = {}, 0.0, []
    print("K5 vs plain (bf16, H=32; bars max|d o| <= 2e-2, max|d lse| <= 1e-3; bitwise: the rotation pass "
          "vs rotate_split, K5 vs K1 on the rotated q, k, and K5 on them under identity tables):")
    for b, grid in [(2, (9, 24, 24)), (1, (9, 16, 24)), (1, (5, 16, 16)), (2, 68)]:
        # a latent grid at D = 128, or the audio stream's T frames at D = 64
        s, d = (grid, 64) if isinstance(grid, int) else (grid[0] * grid[1] * grid[2], 128)
        q, k, v = (torch.randn(b, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        cos, sin = audio_rope_tables(b, s) if d == 64 else rope_tables(b, *grid)
        out, lse = fa.flash_attention_split_rope(q, k, v, cos, sin, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_split_rope_reference(q, k, v, cos, sin, d**-0.5, return_lse=True)
        err_o = (out.float() - ref.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        max_err = max(max_err, err_o, err_lse)

        def unfused():
            return fa.flash_attention(fa.rotate_split(q, cos, sin), fa.rotate_split(k, cos, sin), v)

        qr, kr = fa.rotate_split(q, cos, sin), fa.rotate_split(k, cos, sin)
        rq, rk = fa.rope_rotate(q, k, cos, sin)
        rot_q, rot_k = ((a != r).sum().item() for a, r in ((rq, qr), (rk, kr)))
        o_id, lse_id = fa.flash_attention_split_rope(qr, kr, v, torch.ones_like(cos), torch.zeros_like(sin),
                                                     return_lse=True)
        same_id = torch.equal(out, o_id) and torch.equal(lse, lse_id)
        o1, lse1 = fa.flash_attention(qr, kr, v, return_lse=True)
        k1_o, k1_lse = (out != o1).sum().item(), (lse != lse1).sum().item()
        del rq, rk, o_id, lse_id, o1, lse1
        ms = median_ms(lambda: fa.flash_attention_split_rope(q, k, v, cos, sin))
        rot_ms = median_ms(lambda: fa.rope_rotate(q, k, cos, sin))
        k1_ms = median_ms(lambda: fa.flash_attention(qr, kr, v))
        plain_ms = median_ms(lambda: fa.flash_attention_split_rope_reference(q, k, v, cos, sin, d**-0.5),
                             reps=5, warmup=1)
        unfused_ms = median_ms(unfused)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2), scale=d**-0.5))
        lim = bound(*rope_attention_work(b, s, 32, d))
        dev = device_ms_by_kernel(lambda: fa.flash_attention_split_rope(q, k, v, cos, sin))
        host = host_ms(lambda: fa.flash_attention_split_rope(q, k, v, cos, sin))
        print(f"  B={b} S={s} D={d}: max|d o| {err_o:.3e} max|d lse| {err_lse:.3e}; rotation pass vs rotate_split: "
              f"{rot_q} q and {rot_k} k elements differ; vs K1 on the rotated q, k: {k1_o} o and {k1_lse} lse "
              f"elements differ; under identity tables bitwise equal: {same_id}  K5 {ms:.4f} ms (rotation pass "
              f"{rot_ms:.4f}, K1 on the rotated q, k {k1_ms:.4f})  plain {plain_ms:.4f} ms  K1 + torch rotation "
              f"{unfused_ms:.4f} ms  SDPA forward on the rotated q, k {lib_ms:.4f} ms; "
              f"{100 * lim['bound_ms'] / ms:.1f} % of the {lim['bound_ms']:.4f} ms bound "
              f"({lim['bound_by']}); device time a call " + ", ".join(f"{n} {t:.4f} ms" for n, t in dev.items())
              + f"; host time a call {host:.4f} ms", flush=True)
        if not (err_o <= 2e-2 and err_lse <= 1e-3 and torch.isfinite(out).all()):
            failed.append(f"the plain version at B={b} S={s}")
        if rot_q or rot_k:
            failed.append(f"rotate_split at B={b} S={s} (the rotation pass)")
        if k1_o or k1_lse:
            failed.append(f"K1 on the plainly rotated q and k at B={b} S={s}")
        if not same_id:
            failed.append(f"itself on the plainly rotated q and k under identity tables at B={b} S={s}")
        rows[(b, s)] = (ms, plain_ms, unfused_ms, lib_ms)
        del q, k, v, out, lse, ref, ref_lse, qr, kr
    if failed:
        fail("K5 disagrees with " + "; ".join(failed))

    s, (f, h, w) = 1280, (5, 16, 16)
    q, k, v, do = (torch.randn(1, s, 32, 128, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    cos, sin = rope_tables(1, f, h, w)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k3 = fa.bwd_launch_count
    got = torch.autograd.grad(fa.flash_attention_split_rope(*leaves, cos, sin), leaves, do)
    if fa.bwd_launch_count != k3 + 1:
        fail("the K5 Function's backward did not run K3")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_split_rope_reference(*leaves, cos, sin, 128**-0.5), leaves, do)
    line = f"  K5 Function gradients at B=1 S={s} (K3 on rotated q, k) vs plain autograd:"
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        d = a.float() - r.float()
        l2, rel_max = (d.norm() / r.float().norm()).item(), d.abs().max().item() / r.float().abs().max().item()
        line += f" {name} rel L2 {l2:.2e} max|d| {rel_max:.2e} of max;"
        if not (l2 <= 5e-3 and rel_max <= 2e-2):
            fail(f"the K5 Function's {name} disagrees with plain autograd")
    print(line, flush=True)
    return {"rows": rows, "max_abs_err": max_err}


# The fields of Int8Operands that hold tensors.
INT8_FIELDS = ("q", "k", "v_t", "qk_scale", "v_scale")


def int8_times(fa, q, k, v) -> dict:
    """Median ms of K6 alone (on the plain prologue's operands), of the
    prologue a CUDA call runs (the CUDA one where the package has it, else
    the plain one) and of the whole call, through entry points every version
    of the port has: run with an older checkout's package, the same numbers
    time that version."""
    b, _, h, d = q.shape
    prologue = getattr(fa, "int8_attention_prologue", fa.int8_attention_operands)
    ops = fa.int8_attention_operands(q, k, v, d**-0.5)
    return {
        "k6": median_ms(lambda: fa.int8_attention_kernel(ops, b, h)),
        "prologue": median_ms(lambda: prologue(q, k, v, d**-0.5)),
        "call": median_ms(lambda: fa.flash_attention_int8(q, k, v)),
    }


def int8_turn(fa) -> None:
    """One turn of a timing in turns: :func:`int8_times` at the path's two
    K6 shapes, printed with the package it timed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(19)
    for b, s in [(1, 1280), (2, 5184)]:
        q, k, v = (torch.randn(b, s, 32, 128, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        times = int8_times(fa, q, k, v)
        print(f"  {Path(fa.__file__).parent.parent.parent.name or '.'}: B={b} S={s} "
              + "  ".join(f"{key} {ms:.4f} ms" for key, ms in times.items()), flush=True)


def mufu_floor_ms(b: int, s: int, h: int) -> float:
    """The least time of K6's S^2 H B exponentials on the special-function
    units: 16 a clock an SM at the card's maximum SM clock."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * s * s * h * b / (16 * sms * mhz * 1e6)


def int8_kernel_vs_plain(fa) -> dict:
    """K6 and its CUDA prologue against their plain versions and K6 against
    K1, bf16, H = 32."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(19)
    rows, max_err, worst_l2, worst_k1 = {}, 0.0, 0.0, 0.0
    print("K6 vs plain (bf16, H=32; bars max|d o| <= 2e-2, rel L2 <= 1e-3, p_q codes that differ <= 1e-4 of them; "
          "vs K1 rel L2 < 5e-2; the CUDA prologue bitwise equal to the plain one; two calls bitwise equal):")
    for b, s, d in [(1, 320, 128), (1, 1280, 128), (2, 5184, 128), (1, 1000, 128), (1, 1280, 64)]:
        q, k, v = (torch.randn(b, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        if s == 1000:  # ragged: heads 0-7 get only negative logits, which a max that took the padded keys' 0 would miss
            q, k[:, :, :8] = q.abs(), -k[:, :, :8].abs()
        ops, plain_ops = fa.int8_attention_prologue(q, k, v, d**-0.5), fa.int8_attention_operands(q, k, v, d**-0.5)
        unequal = [name for name in INT8_FIELDS if not torch.equal(getattr(ops, name), getattr(plain_ops, name))]
        del ops, plain_ops
        out, codes = fa.flash_attention_int8(q, k, v, return_codes=True)
        again, codes_again = fa.flash_attention_int8(q, k, v, return_codes=True)
        torch.cuda.synchronize()
        repeats = torch.equal(out, again) and torch.equal(codes, codes_again)
        del again, codes_again
        ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, return_codes=True)
        diff = out.float() - ref.float()
        err, l2 = diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()
        flips, n_codes = (codes != ref_codes).sum().item(), codes.numel()
        del codes, ref_codes
        k1 = fa.flash_attention(q, k, v)
        l2_k1 = ((out.float() - k1.float()).norm() / k1.float().norm()).item()
        max_err, worst_l2, worst_k1 = max(max_err, err), max(worst_l2, l2), max(worst_k1, l2_k1)
        times = int8_times(fa, q, k, v)
        prologue_device_ms = sum(device_ms_by_kernel(lambda: fa.int8_attention_prologue(q, k, v, d**-0.5)).values())
        plain_prologue_ms = median_ms(lambda: fa.int8_attention_operands(q, k, v, d**-0.5))
        plain_ms = median_ms(lambda: fa.flash_attention_int8_reference(q, k, v), reps=5, warmup=1)
        k1_ms = median_ms(lambda: fa.flash_attention(q, k, v))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=d**-0.5))
        share = bound(*int8_attention_work(b, s, 32, d), peak_ops=PEAK_INT8_OPS)["bound_ms"] / times["k6"]
        floor_ms = mufu_floor_ms(b, s, 32)
        print(f"  B={b} S={s} D={d}: max|d o| {err:.3e} rel L2 {l2:.3e}; p_q codes that differ {flips} of {n_codes}; "
              f"vs K1 rel L2 {l2_k1:.3e}; prologue fields unequal {unequal or 'none'}; two calls equal {repeats}  "
              f"K6 {times['k6']:.4f} ms ({100 * share:.1f} % of its bound; MUFU floor {floor_ms:.4f} ms)  "
              f"CUDA prologue {times['prologue']:.4f} ms (device {prologue_device_ms:.4f} ms)  plain prologue "
              f"{plain_prologue_ms:.4f} ms  whole call {times['call']:.4f} ms  plain {plain_ms:.4f} ms  "
              f"K1 {k1_ms:.4f} ms  SDPA forward {lib_ms:.4f} ms", flush=True)
        if unequal:
            fail(f"the CUDA prologue's {', '.join(unequal)} differ from the plain prologue's at B={b} S={s} D={d}")
        if not repeats:
            fail(f"two K6 calls differ at B={b} S={s} D={d}")
        if not (err <= 2e-2 and l2 <= 1e-3 and flips <= 1e-4 * n_codes and torch.isfinite(out).all()):
            fail(f"K6 disagrees with the plain version at B={b} S={s} D={d}")
        if not l2_k1 < 5e-2:
            fail(f"K6 is {l2_k1:.3e} from K1 at B={b} S={s} D={d}, over the quantization bar 5e-2")
        rows[(b, s, d)] = (times["k6"], plain_ms, k1_ms, lib_ms, times["prologue"])
        del q, k, v, out, ref, k1
    print(f"  K6 worst rel L2 {worst_l2:.3e} (bar 1e-3); worst vs K1 {worst_k1:.3e} (bar 5e-2)", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def quant_kernel_vs_plain(qmm) -> dict:
    import torch

    from mlx_video_tpu_torch.ops.linear import Linear
    from mlx_video_tpu_torch.ops.quant import dequantize_affine, quantize_affine, quantize_linear

    # the scale dtype that quantize_dit_params (the q4 run's quantization) gives
    path_sdt = quantize_linear(Linear(64, 8, bias=False, device="cuda"), 64, 4).scales.dtype
    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    rows, max_err, max_l2, min_control = {}, 0.0, 0.0, float("inf")
    cases = [(m, k, n, 4, 64, torch.float32) for m, k, n in SHAPES_K2] + [
        (320, 4096, 4096, 8, 128, torch.float32), (320, 4096, 4096, 2, 32, torch.float32),
        (320, 4096, 4096, 4, 16, torch.float32), (300, 4096, 16384, 4, 64, torch.float32),
        (320, 4096, 4096, 4, 64, torch.bfloat16), (320, 4096, 4096, 4, 64, torch.float16),
    ]
    other_sdt = torch.bfloat16 if path_sdt == torch.float32 else path_sdt
    print(f"K2 vs plain (bf16 x; times after an L2 flush; the q4 run carries {str(path_sdt)[6:]} scales, timed "
          f"beside {str(other_sdt)[6:]} scales, MLX's own snapshots' dtype):")
    for m, k, n, bits, group, sdt in cases:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        packed, scales, biases = quantize_affine(torch.randn(n, k, generator=g, device="cuda") * k**-0.5, group, bits)
        scales, biases = scales.to(sdt), biases.to(sdt)
        y = qmm.quant_matmul(x, packed, scales, biases, bits, group)
        again = qmm.quant_matmul(x, packed, scales, biases, bits, group)
        torch.cuda.synchronize()
        bitwise = torch.equal(y, again)
        ref = qmm.quant_matmul_reference(x, packed, scales, biases, bits, group)
        d = y.float() - ref.float()
        err = d.abs().max().item()
        rel_max, rel_l2 = err / ref.float().abs().max().item(), (d.norm() / ref.float().norm()).item()
        max_err, max_l2 = max(max_err, err), max(max_l2, rel_l2)
        line = (f"  M={m} K={k} N={n} bits={bits} group={group} scales={str(sdt)[6:]}: max|d y| {err:.3e} "
                f"({rel_max:.2e} of max|y|), rel L2 {rel_l2:.2e}, two calls bitwise equal: {bitwise}")
        control = float("inf")
        if sdt == torch.float32:
            rounded = qmm.quant_matmul_reference(x, packed, scales.bfloat16(), biases.bfloat16(), bits, group)
            control = ((rounded.float() - ref.float()).norm() / ref.float().norm()).item()
            min_control = min(min_control, control)
            line += f", control rel L2 {control:.2e}"
            del rounded
        if (m, k, n) in SHAPES_K2 and (bits, sdt) == (4, torch.float32):
            w = dequantize_affine(packed, scales, biases, bits=bits, dtype=torch.bfloat16)
            ms = median_ms(lambda: qmm.quant_matmul(x, packed, scales, biases, bits, group), before=flush.zero_)
            s2, b2 = scales.to(other_sdt), biases.to(other_sdt)
            other_ms = median_ms(lambda: qmm.quant_matmul(x, packed, s2, b2, bits, group), before=flush.zero_)
            plain_ms = median_ms(lambda: qmm.quant_matmul_reference(x, packed, scales, biases, bits, group),
                                 before=flush.zero_)
            dense_ms = median_ms(lambda: x @ w.T, before=flush.zero_)
            b = bound(*quant_matmul_work(m, k, n, bits, group))
            rows[(m, k, n)] = (ms, plain_ms)
            line += (f"  kernel {ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} TFLOP/s; {100 * b['bound_ms'] / ms:.1f} % "
                     f"of the {b['bound_ms']:.4f} ms bound, {b['bound_by']})  {str(other_sdt)[6:]} scales "
                     f"{other_ms:.4f} ms  plain {plain_ms:.4f} ms  dense cuBLAS {dense_ms:.4f} ms")
            del w, s2, b2
        print(line, flush=True)
        if not (rel_max <= 1e-2 and rel_l2 <= 1e-3 and torch.isfinite(y).all()):
            fail(f"K2 disagrees with the plain version at M={m} K={k} N={n} bits={bits} group={group}")
        if not control > 1e-3:
            fail(f"the control (bf16-rounded scales) passes the K2 bar at M={m} K={k} N={n} bits={bits}")
        if not bitwise:
            fail(f"two K2 calls differ at M={m} K={k} N={n} bits={bits} group={group}")
        del x, packed, scales, biases, y, again, ref, d
    del flush
    print(f"  K2 worst rel L2 {max_l2:.3e}; the control's least {min_control:.3e}; bar 1e-3", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def to_card(dit, device, dtype):
    """A copy of the DiT on ``device`` with its parameters in ``dtype``; the
    quantized words, scales and biases (buffers) keep their dtypes."""
    d = copy.deepcopy(dit).to(device)
    for p in d.parameters():
        p.data = p.data.to(dtype)
    return d


def small_slice_check(mode: str) -> None:
    """The narrow distilled slice, the DiT dense, q4, W8A8 or W4A8 (the same
    codes on both sides), bf16 on the card against fp32 on the CPU."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler, upsample_latents
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
        DecoderConfig, init_video_decoder, video_decoder_apply,
    )
    from mlx_video_tpu_torch.ops import int8 as i8
    from mlx_video_tpu_torch.ops.quant import prepare_w4a8, quantize_dit_params
    from mlx_video_tpu_torch.pipelines import denoise as dn
    from mlx_video_tpu_torch.pipelines.generate import create_position_grid, STAGE_1_SIGMAS, subsample_sigmas

    cfg = LTXModelConfig(
        model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, double_precision_rope=True,
        num_attention_heads=4, attention_head_dim=128, num_layers=2,
        cross_attention_dim=512, caption_channels=256,
    )
    g = torch.Generator().manual_seed(5)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    if mode in ("q4", "w4a8"):
        quantize_dit_params(dit, group_size=64, bits=4)  # the same words on both sides
    if mode == "w4a8":
        prepare_w4a8(dit, bits=4)
    if mode == "w8a8":
        i8.quantize_params_w8a8(dit)
    dec_cfg = DecoderConfig(base_channels=64, num_layers_per_block=1)
    dec = init_video_decoder(g, dec_cfg, device="cpu")
    dec.latents_mean.normal_(generator=g).mul_(0.1)
    dec.latents_std.uniform_(0.7, 1.3, generator=g)
    ups = init_latent_upsampler(g, 128, 64, 1, device="cpu")
    lat = torch.randn(1, 128, 5, 8, 8, generator=g)
    ctx = torch.randn(1, 16, 256, generator=g)
    pos = torch.from_numpy(create_position_grid(1, 5, 8, 8))
    sigmas = subsample_sigmas(STAGE_1_SIGMAS, 2, "farthest")

    def run(device, dtype):
        to = dict(device=device, dtype=dtype)
        d = to_card(dit, device, dtype)
        u, m = (copy.deepcopy(x).to(**to) for x in (ups, dec))
        m.latents_mean, m.latents_std = dec.latents_mean.to(device), dec.latents_std.to(device)
        x, _ = dn.denoise(d, cfg, lat.to(**to), pos.to(device), ctx.to(**to), sigmas)
        up = upsample_latents(u, x, m.latents_mean, m.latents_std)
        rgb = video_decoder_apply(m, dec_cfg, up)
        return [t.float().cpu().numpy() for t in (x, up, rgb)]

    ref = run("cpu", torch.float32)
    i8.int8_matmul_count = 0
    got = run("cuda", torch.bfloat16)
    kind = f"{mode} DiT"
    want = 10 * 2 * 2 if mode in ("w8a8", "w4a8") else 0
    if i8.int8_matmul_count != want:
        fail(f"{i8.int8_matmul_count} int8 products in the {kind} card run, want {want}")
    for name, r, o in zip(("stage-1 latents", "upsampled latents", "decoded rgb"), ref, got):
        peak = 2.0 if name == "decoded rgb" else float(np.abs(r).max())
        worst = min(psnr(o[:, :, i], r[:, :, i], peak) for i in range(r.shape[2]))
        print(f"  {kind}, {name}: min per-frame PSNR {worst:.2f} dB (card bf16 vs CPU fp32)", flush=True)
        if not np.isfinite(o).all() or worst < 35.0:
            fail(f"small slice ({kind}) {name} PSNR {worst:.2f} dB < 35 dB")


# The narrow audio decoder and vocoder's waveform SNR bar: bf16 weights and
# fp32 latents on the card, as generate_video decodes, against fp32 on the
# CPU (set from the card's readings: see PERF.md)
AUDIO_SNR_BAR_DB = 37.0


def narrow_audio_check() -> None:
    """Phase 6b: a 2-layer AudioVideo DiT (video 4 x 128 heads, audio 4 x 64)
    through 2 joint distilled steps at 320 video tokens and 34 audio frames,
    bf16 on the card (K1 for both self-attentions) against fp32 on the CPU:
    per-frame video latent PSNR and audio latent PSNR >= 35 dB. Then a narrow
    audio VAE decoder and vocoder on those 34 frames, called on the card as
    generate_video calls them (fp32 latents into bf16 weights, so the
    convolutions run in fp32), with cuDNN's TF32 off (this script's setting)
    and on (PyTorch's default), against fp32 on the CPU: the waveform's SNR
    >= AUDIO_SNR_BAR_DB in both."""
    import math

    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
    from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, decode_audio, init_vocoder
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.ops import flash_attention as fa
    from mlx_video_tpu_torch.pipelines import denoise as dn
    from mlx_video_tpu_torch.pipelines.generate import STAGE_1_SIGMAS, create_position_grid, subsample_sigmas
    from mlx_video_tpu_torch.pipelines.positions import create_audio_position_grid

    cfg = LTXModelConfig(
        model_type=LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT, double_precision_rope=True,
        num_attention_heads=4, attention_head_dim=128, num_layers=2, cross_attention_dim=512, caption_channels=256,
        audio_num_attention_heads=4, audio_attention_head_dim=64, audio_cross_attention_dim=256,
        audio_caption_channels=256,
    )
    g = torch.Generator().manual_seed(17)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    x = dict(lat=torch.randn(1, 128, 5, 8, 8, generator=g), ctx=torch.randn(1, 16, 256, generator=g),
             alat=torch.randn(1, 8, 34, 16, generator=g), actx=torch.randn(1, 16, 256, generator=g))
    pos = torch.from_numpy(create_position_grid(1, 5, 8, 8))
    apos = torch.from_numpy(create_audio_position_grid(1, 34))
    sigmas = subsample_sigmas(STAGE_1_SIGMAS, 2, "farthest")

    def run(device, dtype):
        t = {k: v.to(device, dtype) for k, v in x.items()}
        return dn.denoise(to_card(dit, device, dtype), cfg, t["lat"], pos.to(device), t["ctx"], sigmas,
                          audio_latents=t["alat"], audio_positions=apos.to(device), audio_context=t["actx"])

    ref_v, ref_a = run("cpu", torch.float32)
    fa.launch_count = 0
    got_v, got_a = run("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    if fa.launch_count != 2 * 2 * 2:
        fail(f"narrow AV slice: {fa.launch_count} K1 launches, want 8 (2 layers x 2 steps x 2 streams)")
    ref_v, ref_a, got_v, got_a = (t.float().cpu().numpy() for t in (ref_v, ref_a, got_v, got_a))
    v = min_frame_psnr(got_v, ref_v)
    a = psnr(got_a, ref_a, float(np.abs(ref_a).max()))
    print(f"  narrow AV slice (2 joint distilled steps, 320 video tokens, 34 audio frames): min per-frame video "
          f"latent PSNR {v:.2f} dB, audio latent PSNR {a:.2f} dB (card bf16 vs CPU fp32)", flush=True)
    if not (np.isfinite(got_v).all() and np.isfinite(got_a).all() and v >= 35.0 and a >= 35.0):
        fail(f"narrow AV slice: {v:.2f} / {a:.2f} dB < 35 dB")

    dcfg, vcfg = AudioVAEConfig(ch=32), VocoderConfig(upsample_initial_channel=128)
    dec, voc = init_audio_decoder(g, dcfg, device="cpu", dtype=torch.float32), init_vocoder(g, vcfg, device="cpu",
                                                                                          dtype=torch.float32)
    with torch.no_grad():
        dec.per_channel_statistics.mean_of_means.normal_(generator=g).mul_(0.1)
        dec.per_channel_statistics.std_of_means.uniform_(0.7, 1.3, generator=g)
    z = torch.from_numpy(ref_a)
    ref = decode_audio(z, dec, dcfg, voc, vcfg).numpy()
    dec_card = copy.deepcopy(dec).to("cuda", torch.bfloat16)
    dec_card.per_channel_statistics = copy.deepcopy(dec.per_channel_statistics).to("cuda")  # fp32, as loaded
    voc_card = copy.deepcopy(voc).to("cuda", torch.bfloat16)
    tf32 = torch.backends.cudnn.allow_tf32
    for cudnn_tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        try:
            got = decode_audio(z.to("cuda"), dec_card, dcfg, voc_card, vcfg).cpu().numpy()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        snr = 10 * math.log10(float(np.sum(ref.astype(np.float64) ** 2)
                                    / np.sum((got - ref).astype(np.float64) ** 2)))
        print(f"  narrow audio decoder (ch 32) + vocoder (128 channels) on those 34 frames: waveform {got.shape}, "
              f"SNR {snr:.2f} dB, the card (bf16 weights, fp32 latents, cuDNN TF32 {cudnn_tf32}) vs fp32 on the "
              f"CPU (bar {AUDIO_SNR_BAR_DB:g} dB); rms {ref.std():.3e}", flush=True)
        if got.shape != (2, 240 * (4 * 34 - 3)) or not np.isfinite(got).all() or snr < AUDIO_SNR_BAR_DB:
            fail(f"narrow audio decode (cuDNN TF32 {cudnn_tf32}): shape {got.shape}, SNR {snr:.2f} dB < "
                 f"{AUDIO_SNR_BAR_DB:g} dB")


def lora_slice_check(w4a8: bool = False, audio: bool = False) -> None:
    """One LoRA grad step on the 2-layer narrow DiT (dense, or over a W4A8
    base; with ``audio`` the AudioVideo DiT of phase 6b with adapters on the
    28 linears of a block and 67 audio frames): bf16 on the card against fp32
    on the CPU, same weights (fp32 adapters on both) and draws, the audio
    noise included. The reference takes the bf16-rounded timesteps of both
    streams."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params, ltx_apply
    from mlx_video_tpu_torch.ops.quant import prepare_w4a8, quantize_dit_params
    from mlx_video_tpu_torch.trainer.datasets import Batch
    from mlx_video_tpu_torch.trainer.strategies import compute_loss, draw_inputs, make_inputs, prepare_text_to_video
    from mlx_video_tpu_torch.trainer.train_step import grad_step

    cfg = LTXModelConfig(
        model_type=LTXModelType.AudioVideo if audio else LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT,
        double_precision_rope=True, num_attention_heads=4, attention_head_dim=128, num_layers=2,
        cross_attention_dim=512, caption_channels=256, gradient_checkpointing=True,
        audio_num_attention_heads=4, audio_attention_head_dim=64, audio_cross_attention_dim=256,
        audio_caption_channels=256,
    )
    g = torch.Generator().manual_seed(6)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    if w4a8:
        prepare_w4a8(quantize_dit_params(dit, group_size=64, bits=4), bits=4)
    inject_lora(dit, cfg, LoRAConfig(rank=8, alpha=16.0), g)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.02, generator=g)
    rng = np.random.default_rng(6)
    mask = np.zeros(16, dtype=bool)
    mask[:12] = True
    batch = Batch(
        latents={"latents": rng.normal(size=(1, 128, 5, 8, 8)).astype(np.float32),
                 "num_frames": np.array([[5]]), "height": np.array([[8]]), "width": np.array([[8]])},
        conditions={"video_prompt_embeds": rng.normal(size=(1, 16, 256)).astype(np.float32),
                    "prompt_attention_mask": mask[None]},
    )
    if audio:
        batch.conditions["audio_prompt_embeds"] = rng.normal(size=(1, 16, 256)).astype(np.float32)
        batch.audio_latents = {"latents": rng.normal(size=(1, 8, 67, 16)).astype(np.float32)}
    sb_cpu = prepare_text_to_video(batch, with_audio=audio)
    draws = draw_inputs(sb_cpu, torch.Generator().manual_seed(7), first_frame_conditioning_p=1.0,
                        timestep_sampling_mode="shifted_logit_normal")

    def model_on(device, dtype):
        d = to_card(dit, device, dtype)
        for (name, p), (_, p32) in zip(d.named_parameters(), dit.named_parameters()):
            if ".lora_" in name:
                p.data = p32.data.to(device)  # the adapters stay fp32
        return d, {n: p.requires_grad_() for n, p in d.named_parameters() if ".lora_" in n}

    # the reference: fp32 on the CPU, on the timesteps the bf16 model sees
    d, params = model_on("cpu", torch.float32)
    inputs = make_inputs(sb_cpu, draws)
    m = cfg.timestep_scale_multiplier
    video, audio_in = (None if x is None else x._replace(timesteps=(x.timesteps.bfloat16() * m).float() / m)
                       for x in (inputs.video, inputs.audio))
    with torch.enable_grad():
        video_pred, audio_pred = ltx_apply(d, cfg, video, audio_in)
        ref_loss = compute_loss(video_pred, inputs, audio_pred)
        ref = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))
    ref_loss = ref_loss.item()
    d, params = model_on("cuda", torch.bfloat16)
    loss, got = grad_step(d, params, prepare_text_to_video(batch, with_audio=audio, device="cuda"),
                          type(draws)(*(None if t is None else t.to("cuda") for t in draws)), cfg)
    loss, got = loss.item(), {k: v.float().cpu() for k, v in got.items()}
    del d, params
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    l2 = {k: ((got[k] - r).norm() / r.norm()).item() for k, r in ref.items()}
    worst = max(l2, key=l2.get)
    if audio and not any(".audio_attn1." in k for k in l2):
        fail("the AV LoRA check has no audio adapter")
    print(f"  LoRA step, 2-layer {'W4A8' if w4a8 else 'dense'} {'AV DiT, 320 + 67' if audio else 'DiT, 320'} tokens, sigma {draws.sigmas.item():.6f}: loss card {loss:.6f} vs CPU "
          f"{ref_loss:.6f} (rel {rel_loss:.2e}); "
          f"{len(l2)} LoRA gradients, worst rel L2 {l2[worst]:.3e} at {worst}, median "
          f"{sorted(l2.values())[len(l2) // 2]:.3e}", flush=True)
    if not (rel_loss <= 1e-2 and l2[worst] <= 5e-2):
        fail(f"the {'AV ' if audio else ''}LoRA step on the card disagrees with the CPU reference")


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def small_text_encoder_check() -> None:
    """A tiny Gemma-3 (4 layers of 256; sliding-window and global layers)
    with the connectors on 64 left-padded token ids: bf16 on the card against
    the CPU, dense and W8A8 (the same int8 codes on both sides)."""
    import torch

    from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, init_gemma3_params
    from mlx_video_tpu_torch.models.ltx.text_encoder import encode_tokens, init_text_encoder_params
    from mlx_video_tpu_torch.ops import int8 as i8

    cfg = Gemma3TextConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                           num_attention_heads=4, num_key_value_heads=2, head_dim=64, sliding_window=16,
                           sliding_window_pattern=2)
    g = torch.Generator().manual_seed(17)
    te = init_text_encoder_params(cfg, g, 256, device="cpu", dtype=torch.float32,
                                  language_model=init_gemma3_params(cfg, g, device="cpu", dtype=torch.float32))
    for conn in (te.video_embeddings_connector, te.audio_embeddings_connector):
        conn.learnable_registers.data.normal_(generator=g)
    ids = torch.randint(1, 1024, (2, 64), generator=g)
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[0, :20], ids[0, :20] = 0, 0

    def encode(model, device, dtype):
        with torch.no_grad():
            return encode_tokens(to_card(model, device, dtype), cfg, ids.to(device), mask.to(device))

    for w8a8 in (False, True):
        if w8a8:
            i8.quantize_text_encoder_w8a8(te)
        ref = encode(te, "cpu", torch.float32)
        got = encode(te, "cuda", torch.bfloat16)
        l2 = max(rel_l2(o.cpu(), r) for o, r in zip(got, ref))
        line = f"  tiny Gemma-3 + connectors, {'W8A8' if w8a8 else 'bf16'} on the card: rel L2 {l2:.3e} vs fp32 CPU"
        finite = all(torch.isfinite(o).all() for o in got)
        if w8a8:
            same = max(rel_l2(o.cpu(), r) for o, r in zip(got, encode(te, "cpu", torch.bfloat16)))
            line += f" (bar 4e-2), {same:.3e} vs bf16 CPU (bar 2e-2)"
            ok = finite and l2 <= 4e-2 and same <= 2e-2
        else:
            ok = finite and l2 <= 2e-2
        print(line, flush=True)
        if not ok:
            fail(f"the tiny text encoder on the card disagrees with the CPU ({'W8A8' if w8a8 else 'bf16'})")


def write_training_dataset(root: Path, clips: int = 2) -> None:
    """A seeded PrecomputedDataset at 768x512x65: latents (128, 9, 16, 24)
    fp32 and 1024 caption tokens of 3840 channels, 128 of them real."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    rng = np.random.default_rng(8)
    for sub in ("latents", "conditions"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(clips):
        save_safetensors(root / "latents" / f"clip_{i:03d}.safetensors", {
            "latents": torch.from_numpy(rng.normal(size=(128, 9, 16, 24)).astype(np.float32)),
            "num_frames": torch.tensor([9], dtype=torch.int32),
            "height": torch.tensor([16], dtype=torch.int32),
            "width": torch.tensor([24], dtype=torch.int32),
            "fps": torch.tensor([24.0]),
        })
        mask = torch.zeros(1024, dtype=torch.bool)
        mask[:128] = True
        save_safetensors(root / "conditions" / f"clip_{i:03d}.safetensors", {
            "video_prompt_embeds": torch.from_numpy(rng.normal(size=(1024, 3840)).astype(np.float32)),
            "prompt_attention_mask": mask,
        })


def lora_recipe(**kw):
    """ltx_trainer/configs/ltx2_lora.yaml as a TrainingConfig, with
    gradient checkpointing on."""
    from mlx_video_tpu_torch.trainer.config import TrainingConfig

    base = dict(training_mode="lora", lora_rank=8, lora_alpha=16.0, strategy="text_to_video",
                first_frame_conditioning_p=0.1, lr=1e-4, batch_size=1, grad_accum_steps=1, max_grad_norm=1.0,
                scheduler_type="cosine", timestep_sampling_mode="shifted_logit_normal", timestep_sampling_std=1.0,
                seed=42, enable_gradient_checkpointing=True, handle_preemption=False)
    return TrainingConfig(**{**base, **kw})


def strip_lora(model) -> None:
    for m in model.modules():
        for name in ("lora_A", "lora_B", "lora_scale"):
            if hasattr(m, name):
                delattr(m, name)


def full_width_training(models, fa, data_root: Path, out_root: Path) -> dict:
    """Phase 8: 4 LoRA steps on the in-memory bf16 DiT at 3456 tokens, then a
    resume from state_step_2 in a fresh Trainer."""
    import torch

    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.trainer.datasets import PrecomputedDataset
    from mlx_video_tpu_torch.trainer.trainer import Trainer

    dit = models.transformer
    out = out_root / "dense"
    cfg = lora_recipe(steps=4, save_every=2, output_dir=str(out))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, params=dit, dataset=PrecomputedDataset(data_root))
    print(f"  Trainer set up in {time.perf_counter() - t0:.2f} s: {len(trainer.params)} LoRA tensors, "
          f"{sum(p.numel() for p in trainer.params.values()) / 1e6:.3f} M parameters", flush=True)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = fa.bwd_launch_count = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    k1, k3 = fa.launch_count, fa.bwd_launch_count
    peak = torch.cuda.max_memory_allocated()
    losses, secs = list(trainer.loss_history), list(trainer.step_seconds)
    b_norm = sum(p.float().norm().item() for n, p in trainer.params.items() if n.endswith("lora_B"))
    print(f"  losses {['%.6f' % x for x in losses]}; step seconds {['%.4f' % x for x in secs]}; "
          f"tokens/s after the first step {3456 * (len(secs) - 1) / sum(secs[1:]):.1f}", flush=True)
    print(f"  train wall {wall:.4f} s (saves included); device memory {base_mem / 2**30:.3f} GiB before, peak "
          f"{peak / 2**30:.3f} GiB; launches K1 {k1}, K3 {k3}; sum of LoRA B norms {b_norm:.4e}", flush=True)
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"training losses {losses}")
    if not b_norm > 0:
        fail("the LoRA B factors did not move")
    if (k1, k3) != (4 * 2 * 48, 4 * 48):
        fail(f"{k1} K1 and {k3} K3 launches in 4 steps, want {4 * 2 * 48} and {4 * 48}")
    with SafetensorsReader(out / "lora_step_4.safetensors") as r:
        keys = set(r.keys())
    want = {f"diffusion_model.transformer_blocks.{i}.{m}.lora_{ab}.weight" for i in range(48)
            for m in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q", "attn2.to_k",
                      "attn2.to_v", "attn2.to_out", "ff.proj_in", "ff.proj_out") for ab in "AB"}
    if keys != want:
        fail(f"adapter keys differ from the reference format: {sorted(keys ^ want)[:5]}")
    print(f"  lora_step_4.safetensors: {len(keys)} reference keys; files "
          f"{sorted(p.name for p in out.iterdir())}", flush=True)
    del trainer

    resume_dir = out_root / "resume"
    resume_dir.mkdir()
    shutil.copy(out / "state_step_2.safetensors", resume_dir)
    resumed = Trainer(lora_recipe(steps=4, save_every=2, output_dir=str(resume_dir), resume=True),
                      params=dit, dataset=PrecomputedDataset(data_root))
    if resumed.start_step != 2:
        fail(f"resumed at step {resumed.start_step}, want 2")
    resumed.train()
    again = list(resumed.loss_history)
    print(f"  resumed from state_step_2: losses of steps 2, 3 {['%.6f' % x for x in again]} vs "
          f"{['%.6f' % x for x in losses[2:]]}", flush=True)
    if again != losses[2:]:
        fail("the resumed run's losses differ from the uninterrupted run's")
    profile_lora_step(resumed, fa)
    del resumed
    strip_lora(dit)
    for p in dit.parameters():
        p.requires_grad_(False)
    torch.cuda.empty_cache()
    return {"k1": k1, "k3": k3, "step_seconds": secs, "peak_gib": peak / 2**30}


def profile_lora_step(trainer, fa, tokens: int = 3456) -> None:
    """One more warm step of ``trainer`` (its first batch, the draws of step
    4) under torch.profiler: forward, recompute, backward and the AdamW
    update, ended by reading the loss. Outside the counted run and the
    resume check; it must launch 96 K1 and 48 K3 (twice that with audio:
    the audio self-attention too). Prints ``tokens`` a second and the peak
    memory."""
    import torch

    from mlx_video_tpu_torch.trainer.datasets import iter_batches
    from mlx_video_tpu_torch.trainer.strategies import draw_inputs
    from mlx_video_tpu_torch.trainer.train_step import apply_updates, grad_step
    from mlx_video_tpu_torch.trainer.trainer import step_generator

    cfg = trainer.cfg
    sb = trainer._prepare(next(iter_batches(trainer.dataset, cfg.batch_size, seed=cfg.seed)))
    draws = draw_inputs(sb, step_generator(cfg.seed, cfg.steps, trainer.device),
                        first_frame_conditioning_p=cfg.first_frame_conditioning_p,
                        timestep_sampling_mode=cfg.timestep_sampling_mode,
                        timestep_sampling_std=cfg.timestep_sampling_std)
    streams = 2 if cfg.with_audio else 1
    fa.launch_count = fa.bwd_launch_count = 0
    torch.cuda.reset_peak_memory_stats()
    with profiled(f"one warm {'AV ' if cfg.with_audio else ''}LoRA step ({tokens} tokens; forward, recompute, "
                  "backward, AdamW)") as prof:
        t0 = time.perf_counter()
        loss, grads = grad_step(trainer.model, trainer.params, sb, draws, trainer.model_config)
        apply_updates(trainer.params, trainer.opt_state, grads, trainer.optimizer, 1)
        loss = float(loss)
        step_s = time.perf_counter() - t0
    k1, k3 = fa.launch_count, fa.bwd_launch_count
    busy = prof["busy"]
    shares = {name: 100 * prof["by_class"][key] / 1e3 / busy for name, key in (
        ("K3", "K3 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)"), ("K1", K1_CLASS),
        ("GEMM", "GEMM"), ("elementwise", "other (elementwise, norms, softmax, copies)"))}
    print(f"  profiled LoRA step: {step_s:.4f} s (under the profiler), loss {loss:.6f}, idle share "
          f"{1 - busy / prof['wall']:.3f}; of {busy:.4f} s device busy: "
          + ", ".join(f"{n} {v:.1f} %" for n, v in shares.items())
          + f"; K3 {prof['by_class']['K3 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)'] / max(k3, 1):.4f} ms a call; "
          f"launches K1 {k1}, K3 {k3}; {tokens / step_s:.1f} tokens/s under the profiler; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    want = (2 * 48 * streams, 48 * streams)
    if (k1, k3) != want or not math.isfinite(loss):
        fail(f"the profiled LoRA step: {k1} K1 and {k3} K3 launches (want {want}), loss {loss}")


def full_width_models():
    """The 19B video DiT geometry, the default decoder and the 1024-channel
    upsampler, in bf16, drawn on the card from a seeded generator."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
    from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning

    config = LTXModelConfig(model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT,
                            double_precision_rope=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    # the decoder's own seed: the loader's init (seed 0) must not match it, so
    # a tensor the loader missed shows in the comparison of phase 8
    decoder = init_video_decoder(torch.Generator(device=dev).manual_seed(2), DecoderConfig(), device=dev, dtype=bf16)
    decoder.latents_mean.normal_(generator=g).mul_(0.1)
    decoder.latents_std.uniform_(0.7, 1.3, generator=g)
    models = ModelBundle(
        transformer=init_ltx_params(config, g, device=dev, dtype=bf16),
        transformer_config=config,
        vae_decoder=decoder,
        vae_decoder_config=DecoderConfig(),
        upsampler=init_latent_upsampler(g, 128, 1024, 4, device=dev, dtype=bf16),
    )
    text = TextConditioning(torch.randn(1, 128, config.caption_channels, generator=g, device=dev).to(bf16))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models.transformer.parameters())
    print(f"  synthetic weights drawn on the card in {time.perf_counter() - t0:.2f} s "
          f"(DiT {n_params / 1e9:.2f} B params)", flush=True)
    return models, text


def check_video(video, latents, k1: int, k2: int, want_k2: int, int8: int = 0, want_int8: int = 0) -> None:
    import numpy as np

    if video is None or video.shape != (1, 3, 33, 512, 512):
        fail(f"video shape {None if video is None else video.shape}, want (1, 3, 33, 512, 512)")
    if not np.isfinite(video).all() or not np.isfinite(latents).all():
        fail("non-finite video or latents")
    print(f"  video {video.shape} finite; range [{video.min():.4f}, {video.max():.4f}], "
          f"std {video.std():.4f}", flush=True)
    check_launches(k1, k2, want_k2, int8, want_int8)


def check_launches(k1: int, k2: int, want_k2: int, int8: int = 0, want_int8: int = 0) -> None:
    if k1 != 48 * (8 + 3):
        fail(f"{k1} K1 (flash attention) launches in the run, want {48 * (8 + 3)}")
    if k2 != want_k2:
        fail(f"{k2} K2 (dequantizing matmul) launches in the run, want {want_k2}")
    if int8 != want_int8:
        fail(f"{int8} int8 products in the run, want {want_int8}")


def drive_slice(models, text, fa, qmm, want_k2: int, want_int8: int = 0, output_path=None,
                profile: Optional[str] = None) -> dict:
    """generate_video at 512x512x33, 8 + 3 steps, counts set to 0 just before;
    with ``profile``, one more run (warm) under torch.profiler."""
    import torch

    from mlx_video_tpu_torch.ops import int8 as i8
    from mlx_video_tpu_torch.pipelines.generate import generate_video

    def run(path):
        return generate_video(models, text, height=512, width=512, num_frames=33, stage1_steps=8,
                              stage2_steps=3, tiling="auto", output_path=path,
                              generator=torch.Generator(device="cuda").manual_seed(1))

    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = fa.bwd_launch_count = qmm.launch_count = i8.int8_matmul_count = 0
    t0 = time.perf_counter()
    res = run(output_path)
    wall = time.perf_counter() - t0
    k1, k2, int8 = fa.launch_count, qmm.launch_count, i8.int8_matmul_count
    peak = torch.cuda.max_memory_allocated()
    for name, sec in res.phase_seconds.items():
        print(f"  phase {name}: {sec:.4f} s", flush=True)
    print(f"  generate_video wall {wall:.4f} s; peak device memory {peak / 2**30:.3f} GiB; "
          f"launches K1 {k1}, K2 {k2}; int8 products {int8}", flush=True)
    check_video(res.video, res.latents, k1, k2, want_k2, int8, want_int8)
    if profile:
        with profiled(profile):
            run(None)
    return {"k1": k1, "k2": k2, "int8": int8, "video_path": res.video_path}


# A narrow VAE encoder: the default's five stages at 128 channels, one res
# block at each end (space /32, time /8, as the default).
NARROW_ENCODER_BLOCKS = (
    ("res_x", {"num_layers": 1}), ("compress_space_res", {"multiplier": 1}), ("compress_time_res", {"multiplier": 1}),
    ("compress_all_res", {"multiplier": 1}), ("compress_all_res", {"multiplier": 1}), ("res_x", {"num_layers": 1}),
)


def write_image(path: Path, size: int, seed: int) -> None:
    """A seeded, smooth RGB PNG of size x size, written with cv2 at the size
    the pipeline asks for."""
    import cv2
    import numpy as np

    noise = np.random.default_rng(seed).uniform(0, 255, (size, size, 3)).astype(np.uint8)
    if not cv2.imwrite(str(path), cv2.GaussianBlur(noise, (0, 0), size / 64)):
        fail(f"cv2 could not write {path}")


def vae_on(module, device, dtype):
    """A copy of a VAE module on ``device`` in ``dtype``, its latent
    statistics kept fp32 as the loaders keep them."""
    out = copy.deepcopy(module).to(device=device, dtype=dtype)
    for (_, buf), (_, ref) in zip(out.named_buffers(), module.named_buffers()):
        buf.data = ref.to(device)
    return out


def set_routes(on: bool) -> None:
    """The K4 and K5 routes (MLX_VIDEO_TPU_CROSS_KERNEL, MLX_VIDEO_TPU_FUSED_ROPE),
    on or off in this process."""
    from mlx_video_tpu_torch.ops import attention

    attention.use_cross_kernel(on)
    attention.use_fused_rope(on)


def narrow_dev_check(work: Path) -> None:
    """The dev pipeline at narrow width with the K4 and K5 routes on: a
    2-layer DiT, a narrow encoder and decoder, one image at frame 0, batched
    CFG 4.5, 2 steps at 256x256x17 (192 tokens); bf16 on the card against
    fp32 on the CPU (the plain versions) with the same weights, image and
    noise. Bar: per-frame PSNR >= 35 dB of latents and RGB."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType, VideoVAEConfig
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
    from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning, generate_video

    cfg = LTXModelConfig(
        model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, double_precision_rope=True,
        num_attention_heads=4, attention_head_dim=128, num_layers=2, cross_attention_dim=512, caption_channels=256,
    )
    g = torch.Generator().manual_seed(11)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    dec_cfg, enc_cfg = DecoderConfig(base_channels=64, num_layers_per_block=1), VideoVAEConfig(
        encoder_blocks=NARROW_ENCODER_BLOCKS)
    dec, enc = init_video_decoder(g, dec_cfg, device="cpu"), init_video_encoder(g, enc_cfg, device="cpu")
    dec.latents_mean.normal_(generator=g).mul_(0.1)
    dec.latents_std.uniform_(0.7, 1.3, generator=g)
    enc.per_channel_statistics.mean.copy_(dec.latents_mean)
    enc.per_channel_statistics.std.copy_(dec.latents_std)
    pos, neg = (torch.randn(1, 16, 256, generator=g) for _ in range(2))
    image = work / "narrow.png"
    write_image(image, 256, 11)

    def run(device, dtype):
        models = ModelBundle(to_card(dit, device, dtype), cfg, vae_on(dec, device, dtype), dec_cfg,
                             vae_encoder=vae_on(enc, device, dtype), vae_encoder_config=enc_cfg)
        res = generate_video(models, TextConditioning(pos, neg), height=256, width=256, num_frames=17, pipeline="dev",
                             num_inference_steps=2, cfg_scale=4.5, images=[(str(image), 0, 1.0)], tiling="none",
                             dtype=dtype, generator=torch.Generator().manual_seed(12))
        return res.latents, res.video

    set_routes(True)
    ref, got = run("cpu", torch.float32), run("cuda", torch.bfloat16)
    set_routes(False)
    for name, r, o in zip(("latents", "decoded rgb"), ref, got):
        peak = 2.0 if name == "decoded rgb" else float(np.abs(r).max())
        worst = min(psnr(o[:, :, i], r[:, :, i], peak) for i in range(r.shape[2]))
        print(f"  narrow dev slice (routes on), {name}: min per-frame PSNR {worst:.2f} dB (card bf16 vs CPU fp32)",
              flush=True)
        if not np.isfinite(o).all() or worst < 35.0:
            fail(f"narrow dev slice {name} PSNR {worst:.2f} dB < 35 dB")


# K1's kernel also runs K5's attention (after K5's rotation pass).
K1_CLASS = "K1's kernel (K1, and K5's attention: flash_fwd_kernel)"


@contextlib.contextmanager
def profiled(what: str):
    """torch.profiler over the block, the CUDA activity alone: device busy
    time against the wall (the idle share) and the device time by kernel
    class and of the top kernels. The profiler still slows the host side a
    little, so the idle share is an upper bound. Yields a dict that holds,
    after the block, ``wall`` and ``busy`` seconds and ``by_class`` ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    stats = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield stats
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    counts = {e.key: e.count for e in kernels}
    busy = sum(ms.values()) / 1e3
    classes = {"K5's rotation (rope_rotate_kernel)": "rope_rotate",
               "K4 (cross_resident_kernel, cross_stream_kernel)": ("cross_resident", "cross_stream"),
               K1_CLASS: "flash_fwd", "K3 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)": "flash_bwd",
               "K2 (quant_matmul_kernel)": "quant_matmul",
               "K6 (flash_int8_kernel)": "flash_int8", "convolution": ("conv", "fprop", "implicit"), "int8 GEMM": ("gemm_s8", "imma", "s8s8", "i8i8"),
               "GEMM": ("gemm", "xmma", "nvjet", "cutlass")}
    by_class = dict.fromkeys([*classes, "other (elementwise, norms, softmax, copies)"], 0.0)
    for key, t in ms.items():
        name = next((c for c, pat in classes.items() if any(p in key.lower() for p in (
            (pat,) if isinstance(pat, str) else pat))), "other (elementwise, norms, softmax, copies)")
        by_class[name] += t
    print(f"  profile of {what}: wall {wall:.4f} s, device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}; "
          f"{sum(counts.values())} kernel launches", flush=True)
    for name, t in by_class.items():
        print(f"    {name}: {t:.1f} ms ({100 * t / 1e3 / busy:.1f} % of busy)", flush=True)
    for key in sorted(ms, key=ms.get, reverse=True)[:8]:
        print(f"    top: {ms[key]:.1f} ms over {counts[key]} launches  {key[:110]}", flush=True)
    stats.update(wall=wall, busy=busy, by_class=by_class)


def drive_dev(models, text, images, fa, ca, steps: int, seed: int, **kw):
    """generate_video, dev pipeline, 768x768x65, CFG 4.5, counts set to 0
    just before; returns the result, the K1, K4 and K5 launches and the wall
    seconds."""
    import torch

    from mlx_video_tpu_torch.pipelines.generate import generate_video

    device = models.transformer.video.scale_shift_table.device
    fa.launch_count = fa.bwd_launch_count = fa.rope_launch_count = ca.launch_count = 0
    t0 = time.perf_counter()
    res = generate_video(models, text, height=768, width=768, num_frames=65, pipeline="dev",
                         num_inference_steps=steps, cfg_scale=4.5, images=images, tiling="auto",
                         generator=torch.Generator(device=device).manual_seed(seed), **kw)
    return res, (fa.launch_count, ca.launch_count, fa.rope_launch_count), time.perf_counter() - t0


def check_dev_launches(counts, want, what: str) -> None:
    if tuple(counts) != tuple(want):
        fail(f"{what}: launches K1, K4, K5 {tuple(counts)}, want {tuple(want)}")


def min_frame_psnr(a, b) -> float:
    import numpy as np

    peak = float(np.abs(b).max())
    return min(psnr(a[:, :, i], b[:, :, i], peak) for i in range(b.shape[2]))


def full_width_dev(models, fa, ca, work: Path) -> dict:
    """The dev pipeline on the 19B video DiT geometry with both routes on:
    the 40-step run with one image, then a 2-step A/B of the routes on
    against off, then one step of sequential against batched CFG. The
    seeded default encoder stays on ``models`` for phases 11 and 10."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import VideoVAEConfig
    from mlx_video_tpu_torch.io import media
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder, video_encoder_apply
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning

    device, bf16 = models.transformer.video.scale_shift_table.device, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(13)
    enc_cfg = VideoVAEConfig()
    t0 = time.perf_counter()
    encoder = init_video_encoder(g, enc_cfg, device=device, dtype=bf16)
    encoder.per_channel_statistics.mean.copy_(models.latents_mean)
    encoder.per_channel_statistics.std.copy_(models.latents_std)
    models.vae_encoder, models.vae_encoder_config = encoder, enc_cfg
    caption = models.transformer_config.caption_channels
    text = TextConditioning(*(torch.randn(1, 128, caption, generator=g, device=device).to(bf16) for _ in range(2)))
    image = work / "cond.png"
    write_image(image, 768, 13)
    images = [(str(image), 0, 1.0)]
    print(f"  default encoder ({sum(p.numel() for p in encoder.parameters()) / 1e6:.1f} M params) drawn and a "
          f"768x768 image written in {time.perf_counter() - t0:.2f} s", flush=True)

    set_routes(True)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = drive_dev(models, text, images, fa, ca, steps=40, seed=14)
    peak = torch.cuda.max_memory_allocated()
    for name, sec in res.phase_seconds.items():
        print(f"  phase {name}: {sec:.4f} s", flush=True)
    steps_s = res.phase_seconds["dev_denoise"] / 40
    print(f"  generate_video wall {wall:.4f} s; dev_denoise {steps_s:.4f} s a step; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches K1 {counts[0]}, K4 {counts[1]}, K5 {counts[2]}", flush=True)
    check_dev_launches(counts, (0, 40 * 48, 40 * 48), "the 40-step dev run")
    video = res.video
    if video is None or video.shape != (1, 3, 65, 768, 768) or not np.isfinite(video).all():
        fail(f"dev video {None if video is None else video.shape}, want a finite (1, 3, 65, 768, 768)")
    print(f"  video {video.shape} finite; range [{video.min():.4f}, {video.max():.4f}], std {video.std():.4f}",
          flush=True)
    with torch.no_grad():
        pixels = media.prepare_image_for_encoding(media.load_image(image, 768, 768), 768, 768)
        encoded = video_encoder_apply(encoder, enc_cfg, torch.from_numpy(pixels).to(device, bf16)).float().cpu()
    frame0 = torch.from_numpy(res.latents[:, :, :1])
    d0 = ((frame0 - encoded).abs().max() / encoded.abs().max()).item()
    print(f"  latent frame 0 vs the encoded image: max|d| {d0:.3e} of max (strength 1.0 keeps it clean)", flush=True)
    if not d0 <= 2.0**-8:
        fail("latent frame 0 is not the encoded conditioning image")
    del res, video

    with profiled("2 warm dev steps (routes on; the image encode included)"):
        on, counts_on, _ = drive_dev(models, text, images, fa, ca, steps=2, seed=15, decode_latents_only=True)
    check_dev_launches(counts_on, (0, 96, 96), "the 2-step run with the routes on")
    set_routes(False)
    with profiled("2 warm dev steps (routes off: K1 and plain cross-attention; the image encode included)") as prof:
        off, counts_off, _ = drive_dev(models, text, images, fa, ca, steps=2, seed=15, decode_latents_only=True)
    check_dev_launches(counts_off, (96, 0, 0), "the 2-step run with the routes off")
    k1_ms = prof["by_class"][K1_CLASS]
    print(f"  routes off: K1 {k1_ms:.1f} ms over {counts_off[0]} launches, {100 * k1_ms / 1e3 / prof['busy']:.1f} % "
          f"of device busy time; dev_denoise {off.phase_seconds['dev_denoise'] / 2:.4f} s a step; idle share "
          f"{1 - prof['busy'] / prof['wall']:.3f}", flush=True)
    ab = min_frame_psnr(on.latents, off.latents)
    print(f"  A/B at 2 steps, routes on vs off: min per-frame latent PSNR {ab:.2f} dB; launches on {counts_on}, "
          f"off {counts_off}", flush=True)
    if not ab >= 35.0:
        fail(f"routes on vs off: {ab:.2f} dB < 35 dB")
    # dev_denoise a step without the profiler, routes off and on in turns (off, on, on, off)
    ab_step_s = {True: [], False: []}
    for routes in (False, True, True, False):
        set_routes(routes)
        timed, timed_counts, _ = drive_dev(models, text, images, fa, ca, steps=2, seed=15, decode_latents_only=True)
        check_dev_launches(timed_counts, (0, 96, 96) if routes else (96, 0, 0), "a timed 2-step run")
        ab_step_s[routes].append(timed.phase_seconds["dev_denoise"] / 2)
    print("  dev_denoise a step, in turns (off, on, on, off): routes on "
          + ", ".join(f"{t:.4f}" for t in ab_step_s[True]) + " s; routes off "
          + ", ".join(f"{t:.4f}" for t in ab_step_s[False])
          + f" s; on / off {sum(ab_step_s[True]) / sum(ab_step_s[False]):.3f}",
          flush=True)

    set_routes(True)
    batched, _, b_wall = drive_dev(models, text, images, fa, ca, steps=1, seed=16, decode_latents_only=True)
    seq, counts_seq, s_wall = drive_dev(models, text, images, fa, ca, steps=1, seed=16, decode_latents_only=True,
                                        cfg_sequential=True)
    check_dev_launches(counts_seq, (0, 48 * 2, 48 * 2), "one step of sequential CFG")
    sq = min_frame_psnr(seq.latents, batched.latents)
    print(f"  one step, sequential vs batched CFG: min per-frame latent PSNR {sq:.2f} dB; launches {counts_seq}; "
          f"wall {s_wall:.4f} s vs {b_wall:.4f} s (encode included)", flush=True)
    if not sq >= 35.0:
        fail(f"sequential vs batched CFG: {sq:.2f} dB < 35 dB")
    set_routes(False)
    torch.cuda.empty_cache()
    return {"k4": counts[1], "k5": counts[2], "step_s": steps_s, "peak_gib": peak / 2**30}


def write_clip(path: Path, frames: int, size: int, seed: int, height: Optional[int] = None) -> None:
    """A seeded clip of ``frames`` smooth RGB frames of size x size (or size
    wide and ``height`` high: a blurred pattern that slides 4 pixels a
    frame), written with cv2 (mp4v)."""
    import cv2
    import numpy as np

    height = height or size
    base = cv2.GaussianBlur(np.random.default_rng(seed).uniform(0, 255, (height, size, 3)).astype(np.uint8),
                            (0, 0), size / 64)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (size, height))
    if not writer.isOpened():
        fail(f"cv2 could not open an mp4v writer for {path}")
    for i in range(frames):
        writer.write(np.roll(base, 4 * i, axis=1))
    writer.release()


# Phase 11's runs: the distilled defaults at 512x512x33 (stage 1 at 320 tokens, stage 2 at 1280)
PHASE11_RUN = dict(height=512, width=512, num_frames=33, stage1_steps=8, stage2_steps=3)


def conditioned_run(models, text, fa, what: str, want_k1: Optional[int] = None, videos: int = 1, **kw):
    """Phase 11's generate_video (PHASE11_RUN), the K1 count set to 0 just
    before: prints the phase seconds, wall, peak device memory and K1
    launches; checks finite videos of the full shape and the launches
    (``want_k1``, by default one a block a step)."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.pipelines.generate import generate_video

    run = PHASE11_RUN
    if want_k1 is None:
        want_k1 = models.transformer_config.num_layers * (run["stage1_steps"] + run["stage2_steps"])
    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = 0
    t0 = time.perf_counter()
    res = generate_video(models, text, **run, **kw)
    wall = time.perf_counter() - t0
    k1 = fa.launch_count
    print(f"  {what}: " + ", ".join(f"{n} {s:.4f} s" for n, s in res.phase_seconds.items())
          + f"; wall {wall:.4f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"K1 launches {k1}", flush=True)
    shape = (videos, 3, run["num_frames"], run["height"], run["width"])
    if res.video is None or res.video.shape != shape or not np.isfinite(res.video).all() \
            or not np.isfinite(res.latents).all():
        fail(f"{what}: video {None if res.video is None else res.video.shape}, want a finite {shape}")
    if k1 != want_k1:
        fail(f"{what}: {k1} K1 launches, want {want_k1}")
    return res, k1


IC_LORA_LINEARS = [f"{attn}.{lin}" for attn in ("attn1", "attn2") for lin in ("to_q", "to_k", "to_v", "to_out.0")]


def ic_lora_adapter(path: Path, config, device) -> dict:
    """A seeded adapter in the reference format on the recipe of
    ltx_trainer/configs/ltx2_ic_lora_v2v.yaml: rank 32 on to_q, to_k, to_v
    and to_out.0 of attn1 and attn2 in every block (384 pairs at 48 blocks),
    bf16."""
    import torch

    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    g = torch.Generator(device=device).manual_seed(33)
    d, state = config.inner_dim, {}
    for i in range(config.num_layers):
        for lin in IC_LORA_LINEARS:
            key = f"diffusion_model.transformer_blocks.{i}.{lin}"
            state[f"{key}.lora_A.weight"] = (torch.randn(32, d, generator=g, device=device) * 0.02).bfloat16()
            state[f"{key}.lora_B.weight"] = (torch.randn(d, 32, generator=g, device=device) * 0.02).bfloat16()
    save_safetensors(path, state)
    return state


def full_width_conditioned(models, text, fa, work: Path) -> dict:
    """Phase 11: the conditioned distilled slice at full width on the bf16
    DiT, with the seeded default encoder of phase 7a: (a) an image in replace
    mode, (b) keyframes in guide mode, streamed, (c) IC-LoRA on a merged
    adapter, (f) two videos in one batch, (d) a LoRA-merged stage-2 copy,
    (e) stage-2 CFG batched and sequential."""
    import dataclasses

    import numpy as np
    import torch

    from mlx_video_tpu_torch.io import media
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.models.ltx.video_vae import tiling
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import add_decode_noise, video_decoder_apply
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import video_encoder_apply
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning, decode_latents, select_tiling

    device, bf16 = models.transformer.video.scale_shift_table.device, torch.bfloat16
    config = models.transformer_config
    size, frames = PHASE11_RUN["height"], PHASE11_RUN["num_frames"]
    t_phase = time.perf_counter()
    runs = {}
    key_a, key_b, clip = work / "key_a.png", work / "key_b.png", work / "reference.mp4"
    write_image(key_a, size, 31)
    write_image(key_b, size, 32)
    write_clip(clip, frames, size, 33)

    res, runs["a"] = conditioned_run(models, text, fa, "(a) one image at frame 0, replace mode",
                                     images=[(str(key_a), 0, 1.0)], seed=31)
    with torch.no_grad():
        pixels = media.prepare_image_for_encoding(media.load_image(key_a, size, size), size, size)
        encoded = video_encoder_apply(models.vae_encoder, models.vae_encoder_config,
                                      torch.from_numpy(pixels).to(device, bf16)).float().cpu()
    d0 = ((torch.from_numpy(res.latents[:, :, :1]) - encoded).abs().max() / encoded.abs().max()).item()
    print(f"  (a) latent frame 0 vs the encoded {size}x{size} image: max|d| {d0:.3e} of max (bar 2^-8)", flush=True)
    if not d0 <= 2.0**-8:
        fail("(a) latent frame 0 is not the encoded conditioning image")

    keyframes = [(str(key_a), 0, 1.0), (str(key_b), frames - 1, 1.0)]
    written, write = [], media.VideoWriter.write

    def recording(self, frames):
        written.append(frames.copy())
        return write(self, frames)

    media.VideoWriter.write = recording
    try:
        streamed, runs["b"] = conditioned_run(models, text, fa, "(b) keyframes at media frames 0 and 32, guide "
                                              "mode, streamed", pipeline="keyframe", images=keyframes, stream=True,
                                              output_path=work / "keyframe.mp4", seed=32)
    finally:
        media.VideoWriter.write = write
    got = np.concatenate(written)
    same = got.shape == (frames, size, size, 3) and np.array_equal(got, media.frames_to_uint8(streamed.video)[:frames])
    print(f"  (b) the writer received {len(written)} pieces of {[len(w) for w in written]} frames; concatenated "
          f"they equal frames_to_uint8 of the returned video bit for bit: {same}", flush=True)
    if len(written) < 2 or not same:
        fail("(b) the streamed frames are not the returned video's, in order, in more than one piece")
    whole, runs["b_unstreamed"] = conditioned_run(models, text, fa, "(b) the same seed without the stream",
                                                  pipeline="keyframe", images=keyframes, seed=32)
    same_latents = np.array_equal(streamed.latents, whole.latents)
    frame_db = [psnr(streamed.video[:, :, i], whole.video[:, :, i], 2.0) for i in range(frames)]
    print(f"  (b) streamed vs unstreamed: latents bitwise equal {same_latents}; RGB per frame, two temporal tiles "
          f"against none (no bar: a tiled decode on seeded weights, see PERF.md), min {min(frame_db):.2f} dB, "
          f"frames 0-8 min {min(frame_db[:9]):.2f} dB, max {max(frame_db):.2f} dB", flush=True)
    if not same_latents:
        fail("(b) the stream changed the latents")
    # the device blend against the host blend on the same tiles and decode noise
    cfg = select_tiling("auto", size, size, frames, stream=True)
    lat = torch.from_numpy(streamed.latents).to(device, bf16)
    ts = torch.full((1,), 0.05, device=device)
    noisy = add_decode_noise(models.vae_decoder_config, lat, generator=torch.Generator(device=device).manual_seed(7))
    t0 = time.perf_counter()
    host = tiling.decode_with_tiling(
        lambda t: video_decoder_apply(models.vae_decoder, models.vae_decoder_config, torch.from_numpy(t).to(device, bf16),
                                      timestep=ts).float().cpu().numpy(),
        noisy.float().cpu().numpy(), cfg)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = decode_latents(models, lat, cfg, decode_timestep=0.05, generator=torch.Generator(device=device).manual_seed(7))
    t_card = time.perf_counter() - t0
    d_blend = float(np.abs(on_card - host).max())
    print(f"  (b) decode with the device blend vs the host blend (2 temporal tiles): max|d| {d_blend:.3e} "
          f"(bar 1e-6); {t_card:.4f} s vs {t_host:.4f} s", flush=True)
    if not d_blend <= 1e-6:
        fail(f"(b) the device blend differs from the host blend by {d_blend:.3e}")
    del host, on_card, lat, noisy, streamed, whole

    adapter = work / "ic_lora.safetensors"
    state = ic_lora_adapter(adapter, config, device)
    pairs = len(state) // 2
    base = models.transformer
    names = ("blocks.0.attn1.to_q", f"blocks.{config.num_layers - 1}.attn2.to_out")
    base_w = {name: base.get_submodule(name).weight.detach().cpu().clone() for name in names}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        merged = merge_lora_into_params(base, [LoraSpec(adapter, 1.0)], verbose=True)
    torch.cuda.synchronize()
    print(f"  (c) {out.getvalue().strip()}; merge {time.perf_counter() - t0:.3f} s; device memory "
          f"{before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if f"applied={pairs} skipped=0" not in out.getvalue():
        fail(f"(c) the IC-LoRA adapter did not merge into all {pairs} linears")
    for name in names:
        key = "diffusion_model.transformer_blocks." + name[len("blocks."):].replace("to_out", "to_out.0")
        a, b = state[f"{key}.lora_A.weight"].float().cpu(), state[f"{key}.lora_B.weight"].float().cpu()
        want = (base_w[name].float() + (b @ a) * 1.0).to(bf16)
        ulps = (merged.get_submodule(name).weight.cpu().view(torch.int16).long() - want.view(torch.int16).long()).abs()
        n = int((ulps > 0).sum())
        print(f"  (c) {name}: merged on the card vs the CPU merge: {n} of {ulps.numel()} elements differ, by at "
              f"most {int(ulps.max())} bf16 ulp (bar: 1e-4 of them, 1 ulp)", flush=True)
        if ulps.max() > 1 or n > 1e-4 * ulps.numel():
            fail(f"(c) the merged {name} differs from the CPU merge")
    del state
    _, runs["c"] = conditioned_run(dataclasses.replace(models, transformer=merged), text, fa,
                                   f"(c) IC-LoRA: a {frames}-frame reference clip at frame 0 on the merged DiT",
                                   pipeline="ic_lora", video_conditionings=[(str(clip), 0, 1.0)], seed=33)
    same = all(torch.equal(base.get_submodule(name).weight.cpu(), base_w[name]) for name in names)
    print(f"  (c) the base DiT's {', '.join(names)} are unchanged: {same}", flush=True)
    if not same:
        fail("(c) the merge changed the base model")

    batched, runs["f"] = conditioned_run(models, text, fa, "(f) num_videos=2 at seeds 35 and 36", videos=2,
                                         num_videos=2, seed=35, output_path=work / "batch.mp4")
    files = [work / f"batch_{i}.mp4" for i in range(2)]
    if not all(f.is_file() and f.stat().st_size > 0 for f in files):
        fail(f"(f) the batch wrote {[f.name for f in files if f.is_file()]}, want batch_0.mp4 and batch_1.mp4")
    singles = [conditioned_run(models, text, fa, f"(f) the single run at seed {35 + i}", seed=35 + i)[0]
               for i in range(2)]
    worst = min(min_frame_psnr(batched.latents[i : i + 1], singles[i].latents) for i in range(2))
    print(f"  (f) batched vs single runs: min per-frame latent PSNR {worst:.2f} dB (bar 35); files "
          f"{[f.name for f in files]}", flush=True)
    if not worst >= 35.0:
        fail(f"(f) a batched video is {worst:.2f} dB from its single run")

    with_lora, runs["d"] = conditioned_run(dataclasses.replace(models, stage2_transformer=merged), text, fa,
                                           "(d) stage 2 on the merged DiT of (c), stage 1 on the base, seed 35",
                                           seed=35)
    moved = float(np.abs(with_lora.latents - singles[0].latents).max())
    print(f"  (d) latents vs the same seed without the stage-2 copy: max|d| {moved:.4e} (must be > 0)", flush=True)
    if not moved > 0:
        fail("(d) the LoRA-merged stage-2 model changed nothing")
    del merged, with_lora, batched, singles
    torch.cuda.empty_cache()

    g = torch.Generator(device=device).manual_seed(36)
    neg = torch.randn(*text.video_embeddings.shape, generator=g, device=device).to(bf16)
    cfg_text = TextConditioning(text.video_embeddings, neg)
    cfg_b, runs["e_batched"] = conditioned_run(models, cfg_text, fa, "(e) stage-2 CFG 4.0, batched", seed=36,
                                               stage2_cfg=True, cfg_scale=4.0)
    layers = config.num_layers
    cfg_s, runs["e_sequential"] = conditioned_run(
        models, cfg_text, fa, "(e) stage-2 CFG 4.0, sequential", seed=36, stage2_cfg=True, cfg_scale=4.0,
        want_k1=layers * PHASE11_RUN["stage1_steps"] + 2 * layers * PHASE11_RUN["stage2_steps"], cfg_sequential=True)
    de = min_frame_psnr(cfg_s.latents, cfg_b.latents)
    print(f"  (e) sequential vs batched stage-2 CFG: min per-frame latent PSNR {de:.2f} dB (bar 35)", flush=True)
    if not de >= 35.0:
        fail(f"(e) sequential vs batched stage-2 CFG: {de:.2f} dB < 35 dB")
    print(f"  phase 11: {time.perf_counter() - t_phase:.2f} s; K1 launches by run {runs}", flush=True)
    return {"k1": runs, "adapter": adapter, "keyframes": keyframes, "pairs": pairs}


# Phase 12: audio. The seed of the audio and cross-modal tensors; phase 10
# (d) draws the same tensors again from it on the q4 video modules.
AUDIO_SEED = 41


def audio_video_model(dit, seed: int = AUDIO_SEED):
    """The 19B AudioVideo DiT on ``dit``'s video modules (shared, not
    copied), its audio and cross-modal tensors drawn on the card from
    ``seed`` (the video modules draw nothing, so the draws do not depend on
    them being dense or 4-bit)."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import LTXModel, init_params_

    cfg = LTXModelConfig(model_type=LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT, double_precision_rope=True)
    device = dit.video.scale_shift_table.device
    av = LTXModel(cfg, device="meta", dtype=dit.video.scale_shift_table.dtype)
    av.video = dit.video
    for blk, vblk in zip(av.blocks, dit.blocks):
        blk.attn1, blk.attn2, blk.ff, blk.scale_shift_table = vblk.attn1, vblk.attn2, vblk.ff, vblk.scale_shift_table
    init_params_(av, torch.Generator(device=device).manual_seed(seed), device)
    return av, cfg


def audio_only_model(av):
    """The AudioOnly DiT on the AudioVideo model's audio modules (shared)."""
    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import LTXModel

    cfg = LTXModelConfig(model_type=LTXModelType.AudioOnly, rope_type=LTXRopeType.SPLIT, double_precision_rope=True)
    ao = LTXModel(cfg, device="meta", dtype=av.audio.scale_shift_table.dtype)
    ao.audio = av.audio
    for blk, ablk in zip(ao.blocks, av.blocks):
        for name in ("audio_attn1", "audio_attn2", "audio_ff", "audio_scale_shift_table"):
            setattr(blk, name, getattr(ablk, name))
    if any(p.is_meta for p in ao.parameters()):
        fail("the AudioOnly model has parameters the AudioVideo one does not share")
    return ao, cfg


def audio_decoders(device, seed: int = 43):
    """The default audio VAE decoder and vocoder, seeded bf16 on the card
    (latent statistics drawn too)."""
    import torch

    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
    from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder

    g = torch.Generator(device=device).manual_seed(seed)
    dec = init_audio_decoder(g, AudioVAEConfig(), device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        dec.per_channel_statistics.mean_of_means.normal_(generator=g).mul_(0.1)
        dec.per_channel_statistics.std_of_means.uniform_(0.7, 1.3, generator=g)
    return dict(audio_decoder=dec, audio_decoder_config=AudioVAEConfig(),
                vocoder=init_vocoder(g, VocoderConfig(), device=device, dtype=torch.bfloat16),
                vocoder_config=VocoderConfig())


def audio_frames_for(num_frames: int) -> int:
    from mlx_video_tpu_torch.pipelines.positions import compute_audio_frames

    return compute_audio_frames(num_frames, 24.0)


def check_wav(path, t: int, what: str) -> None:
    """A 24 kHz, 2-channel WAV of 240 (4T - 3) samples a channel at ``path``."""
    import wave

    want = 240 * (4 * t - 3)
    if path is None or not Path(path).is_file():
        fail(f"{what}: audio asked for and no WAV written")
    with wave.open(str(path), "rb") as wf:
        got = (wf.getnchannels(), wf.getnframes(), wf.getframerate())
    if got != (2, want, 24000):
        fail(f"{what}: WAV (channels, samples, rate) {got}, want (2, {want}, 24000)")
    print(f"  {what}: {Path(path).name}, 2 channels x {want} samples at 24 kHz (T = {t}: 240 x (4T - 3))", flush=True)


def check_mp4_audio(path, what: str) -> None:
    """With ffmpeg, the mp4 must carry an audio stream (ffprobe); without it,
    the silent video is the output, as the JAX function leaves it."""
    if path is None or not Path(path).is_file() or Path(path).stat().st_size == 0:
        fail(f"{what}: no mp4 at {path}")
    probe = shutil.which("ffprobe")
    if shutil.which("ffmpeg") is None or probe is None:
        print(f"  {what}: {Path(path).name} {Path(path).stat().st_size} bytes, silent (no ffmpeg here to mux)",
              flush=True)
        return
    streams = subprocess.run([probe, "-v", "error", "-show_entries", "stream=codec_type", "-of", "csv=p=0",
                              str(path)], capture_output=True, text=True, timeout=60).stdout.split()
    if "audio" not in streams:
        fail(f"{what}: the mp4 has no audio stream (streams {streams})")
    print(f"  {what}: {Path(path).name} with streams {streams}", flush=True)


def audio_run(models, text, fa, ca, what: str, want: dict, **kw):
    """generate_video with audio, the K1, K4 and K5 counts set to 0 just
    before: prints the phase seconds, wall, peak memory and launches, checks
    the launches in ``want`` and finite video and audio latents; with an
    output path, the waveform, the WAV and the mp4."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.pipelines.generate import generate_video

    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = fa.rope_launch_count = ca.launch_count = 0
    t0 = time.perf_counter()
    res = generate_video(models, text, audio=True, tiling="auto", **kw)
    wall = time.perf_counter() - t0
    counts = {"k1": fa.launch_count, "k4": ca.launch_count, "k5": fa.rope_launch_count}
    print(f"  {what}: " + ", ".join(f"{n} {s:.4f} s" for n, s in res.phase_seconds.items())
          + f"; wall {wall:.4f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          + ", ".join(f"{k.upper()} {v}" for k, v in counts.items()), flush=True)
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        fail(f"{what}: launches (got, want) {bad}")
    t = audio_frames_for(kw["num_frames"])
    if res.audio_latents is None or res.audio_latents.shape != (1, 8, t, 16) or not np.isfinite(
            res.audio_latents).all() or not np.isfinite(res.latents).all():
        fail(f"{what}: audio latents {None if res.audio_latents is None else res.audio_latents.shape}, want a finite "
             f"(1, 8, {t}, 16)")
    if kw.get("output_path") is not None:
        shape = (1, 3, kw["num_frames"], kw["height"], kw["width"])
        if res.video is None or res.video.shape != shape or not np.isfinite(res.video).all():
            fail(f"{what}: video {None if res.video is None else res.video.shape}, want a finite {shape}")
        wav = res.audio
        if wav is None or wav.shape != (2, 240 * (4 * t - 3)) or not np.isfinite(wav).all():
            fail(f"{what}: waveform {None if wav is None else wav.shape}, want a finite (2, {240 * (4 * t - 3)})")
        print(f"  {what}: video {shape} and waveform {wav.shape} finite; waveform range [{wav.min():.4f}, "
              f"{wav.max():.4f}], rms {float(np.sqrt(np.mean(wav ** 2))):.4f}", flush=True)
        check_wav(res.audio_path, t, what)
        check_mp4_audio(res.video_path, what)
    return res, counts


@contextlib.contextmanager
def launch_shapes(fa, qmm):
    """Records the shape of every K1, K3 and K2 launch in the block: K1's and
    K3's (B, S, H, D) and K2's (M, K, N, bits, group), read from the
    arguments of their bound C entries, which are wrapped for the block. The
    Python wrappers and their counts are untouched."""
    k1_fn, k3_fn, k2_fn = fa._kernel(), fa._kernel("mvt_flash_attention_bwd_bf16"), qmm._kernel()
    shapes = {"k1": set(), "k3": set(), "k2": set()}

    def k1(*args):
        shapes["k1"].add(tuple(args[5:9]))
        return k1_fn(*args)

    def k3(*args):
        shapes["k3"].add(tuple(args[10:14]))
        return k3_fn(*args)

    def k2(*args):
        m, n, k, bits, group = args[5:10]
        shapes["k2"].add((m, k, n, bits, group))
        return k2_fn(*args)

    fns = fa._fns
    fns["mvt_flash_attention_fwd_bf16"], fns["mvt_flash_attention_bwd_bf16"], qmm._fn = k1, k3, k2
    try:
        yield shapes
    finally:
        fns["mvt_flash_attention_fwd_bf16"], fns["mvt_flash_attention_bwd_bf16"], qmm._fn = k1_fn, k3_fn, k2_fn


def check_compared(shapes: dict, what: str) -> None:
    """Fails unless every recorded K1, K3 and K2 shape is one that phase 3, 5
    or 4 compared with the plain version."""
    compared = {"k1": {(b, s, 32, d) for b, s, d, _ in K1_SHAPES},
                "k3": {(1, s, 32, d) for s, d in K3_SHAPES},
                "k2": {(m, k, n, 4, 64) for m, k, n in SHAPES_K2}}
    print(f"  {what}: K1 ran at (B, S, H, D) {sorted(shapes['k1'])}; K3 at {sorted(shapes['k3'])}; K2 at "
          f"(M, K, N, bits, group) {sorted(shapes['k2'])}", flush=True)
    missed = {name: sorted(got - compared[name]) for name, got in shapes.items() if got - compared[name]}
    if missed:
        fail(f"{what}: launches at shapes phases 3-5 never compared with the plain version: {missed}")


def full_width_audio(models, text, fa, ca, work: Path) -> dict:
    """Phase 12: the AudioVideo model (the video DiT's modules plus seeded
    audio and cross-modal tensors), the AudioOnly one on its audio modules,
    the default audio VAE decoder and vocoder; (a) joint distilled, with a
    warm profiled run; (b) separate distilled; (c) joint dev with an image,
    CFG and both routes on, then routes on/off and sequential/batched CFG
    A/Bs. The audio tensors are freed at the end."""
    import dataclasses

    import numpy as np
    import torch

    from mlx_video_tpu_torch.io import media
    from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import decode_audio
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import video_encoder_apply
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning

    device, bf16 = models.transformer.video.scale_shift_table.device, torch.bfloat16
    t_phase = time.perf_counter()
    av, av_cfg = audio_video_model(models.transformer)
    ao, ao_cfg = audio_only_model(av)
    decoders = audio_decoders(device)
    video_ids = {id(p) for p in models.transformer.parameters()}
    n_av = sum(p.numel() for p in av.parameters())
    n_audio = sum(p.numel() for p in av.parameters() if id(p) not in video_ids)
    torch.cuda.synchronize()
    print(f"  AudioVideo DiT {n_av / 1e9:.2f} B params ({n_audio / 1e9:.2f} B audio and cross-modal, drawn on the "
          f"card; {n_audio * 2 / 2**30:.2f} GiB bf16), AudioOnly DiT {sum(p.numel() for p in ao.parameters()) / 1e9:.2f}"
          f" B params (shared), audio decoder {sum(p.numel() for p in decoders['audio_decoder'].parameters()) / 1e6:.1f}"
          f" M, vocoder {sum(p.numel() for p in decoders['vocoder'].parameters()) / 1e6:.1f} M, in "
          f"{time.perf_counter() - t_phase:.2f} s; ffmpeg on this machine: {shutil.which('ffmpeg') is not None}",
          flush=True)
    g = torch.Generator(device=device).manual_seed(44)
    video_neg, audio, audio_neg = (torch.randn(1, 128, 3840, generator=g, device=device).to(bf16) for _ in range(3))
    joint = dataclasses.replace(models, transformer=av, transformer_config=av_cfg, **decoders)
    separate = dataclasses.replace(models, audio_transformer=ao, audio_transformer_config=ao_cfg, **decoders)
    distilled_text = TextConditioning(text.video_embeddings, None, audio, audio_neg)
    steps = PHASE11_RUN["stage1_steps"] + PHASE11_RUN["stage2_steps"]

    def gen():
        return torch.Generator(device=device).manual_seed(45)

    # (a) joint AV, distilled
    want_a = 2 * 48 * steps
    res_a, counts_a = audio_run(joint, distilled_text, fa, ca, "(a) joint AV distilled", {"k1": want_a, "k4": 0,
                                "k5": 0}, **PHASE11_RUN, audio_mode="joint", output_path=work / "a.mp4",
                                generator=gen())
    with profiled("a warm joint AV distilled run"):
        audio_run(joint, distilled_text, fa, ca, "(a) warm, profiled", {"k1": want_a}, **PHASE11_RUN,
                  audio_mode="joint", output_path=work / "a_warm.mp4", generator=gen())
    latents = torch.from_numpy(res_a.audio_latents).to(device).float()
    with profiled("decode_audio alone on (a)'s latents (fp32, as generate_video calls it)"), torch.no_grad():
        decode_audio(latents, decoders["audio_decoder"], joint.audio_decoder_config, decoders["vocoder"],
                     joint.vocoder_config)
    del latents

    # (b) separate audio, distilled: the AudioOnly DiT after the video, 8 steps, batched CFG
    want_b = 48 * steps + 48 * 8
    res_b, counts_b = audio_run(separate, distilled_text, fa, ca, "(b) separate audio distilled", {"k1": want_b},
                         **PHASE11_RUN, audio_steps=8, output_path=work / "b.mp4", generator=gen())
    print(f"  (b) audio_denoise {res_b.phase_seconds['audio_denoise']:.4f} s for 8 steps at B = 2 (CFG)", flush=True)

    # (c) joint AV, dev: BASELINE config 3 with audio, both routes on
    dev_text = TextConditioning(text.video_embeddings, video_neg, audio, audio_neg)
    image = work / "audio_cond.png"
    write_image(image, 768, 46)
    dev_run = dict(height=768, width=768, num_frames=65, pipeline="dev", cfg_scale=4.5, images=[(str(image), 0, 1.0)])
    set_routes(True)
    res_c, counts_c = audio_run(joint, dev_text, fa, ca, "(c) joint AV dev (routes on)",
                                {"k1": 0, "k4": 40 * 4 * 48, "k5": 40 * 2 * 48}, **dev_run, num_inference_steps=40,
                                output_path=work / "c.mp4", generator=gen())
    with torch.no_grad():
        pixels = media.prepare_image_for_encoding(media.load_image(image, 768, 768), 768, 768)
        encoded = video_encoder_apply(models.vae_encoder, models.vae_encoder_config,
                                      torch.from_numpy(pixels).to(device, bf16)).float().cpu()
    d0 = ((torch.from_numpy(res_c.latents[:, :, :1]) - encoded).abs().max() / encoded.abs().max()).item()
    print(f"  (c) latent frame 0 vs the encoded image: max|d| {d0:.3e} of max", flush=True)
    if not d0 <= 2.0**-8:
        fail("(c) latent frame 0 is not the encoded conditioning image")
    del res_a, res_b, res_c

    def ab(a, b, what: str) -> None:
        v = min_frame_psnr(a.latents, b.latents)
        aud = psnr(a.audio_latents, b.audio_latents, float(np.abs(b.audio_latents).max()))
        same = np.array_equal(a.latents, b.latents) and np.array_equal(a.audio_latents, b.audio_latents)
        print(f"  {what}: min per-frame video latent PSNR {v:.2f} dB, audio latent PSNR {aud:.2f} dB; bitwise "
              f"equal: {same}", flush=True)
        if not (v >= 35.0 and aud >= 35.0):
            fail(f"{what}: {v:.2f} / {aud:.2f} dB < 35 dB")

    short = dict(**dev_run, decode_latents_only=True)
    on, _ = audio_run(joint, dev_text, fa, ca, "(c) 2 steps, routes on", {"k1": 0, "k4": 2 * 4 * 48,
                      "k5": 2 * 2 * 48}, **short, num_inference_steps=2, generator=gen())
    set_routes(False)
    off, _ = audio_run(joint, dev_text, fa, ca, "(c) 2 steps, routes off", {"k1": 2 * 2 * 48, "k4": 0, "k5": 0},
                       **short, num_inference_steps=2, generator=gen())
    ab(on, off, "(c) routes on vs off at 2 steps")
    set_routes(True)
    batched, _ = audio_run(joint, dev_text, fa, ca, "(c) 1 step, batched CFG", {"k4": 4 * 48, "k5": 2 * 48},
                           **short, num_inference_steps=1, generator=gen())
    seq, _ = audio_run(joint, dev_text, fa, ca, "(c) 1 step, sequential CFG", {"k4": 2 * 4 * 48, "k5": 2 * 2 * 48},
                       **short, num_inference_steps=1, cfg_sequential=True, generator=gen())
    ab(seq, batched, "(c) sequential vs batched CFG at 1 step")
    set_routes(False)
    del av, ao, joint, separate, decoders, on, off, batched, seq
    torch.cuda.empty_cache()
    print(f"  phase 12 (a)-(c): {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"k1": {"audio_joint_distilled": counts_a["k1"], "audio_separate_distilled": counts_b["k1"]},
            "k4": counts_c["k4"], "k5": counts_c["k5"]}


def full_width_w8a8(models, text, fa, qmm) -> dict:
    """Phase 9a's W8A8 run: a W8A8 copy of the bf16 DiT (Int8Linears; every
    other tensor shared with the bf16 model), the distilled run with the q,
    k, v of the first stage-2 step's attn1 calls recorded, then K6 and K1 on
    them."""
    import dataclasses
    import itertools

    import torch

    from mlx_video_tpu_torch.ops import attention
    from mlx_video_tpu_torch.ops import int8 as i8
    from mlx_video_tpu_torch.ops.linear import Int8Linear

    dit = models.transformer
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    w8 = copy.deepcopy(dit, {id(t): t for t in itertools.chain(dit.parameters(), dit.buffers())})
    i8.quantize_params_w8a8(w8)
    torch.cuda.synchronize()
    n = sum(isinstance(m, Int8Linear) for m in w8.modules())
    print(f"  W8A8 copy in {time.perf_counter() - t0:.2f} s: {n} Int8Linears; device memory "
          f"{before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    if n != 10 * 48:
        fail(f"{n} Int8Linears, want {10 * 48}")

    captured, flash = [], attention.flash_attention

    def recording(q, k, v, *args, **kw):
        if q.shape[1] == 1280 and len(captured) < 48:
            captured.append((q.clone(), k.clone(), v.clone()))
        return flash(q, k, v, *args, **kw)

    attention.flash_attention = recording
    try:
        drive_slice(dataclasses.replace(models, transformer=w8), text, fa, qmm, want_k2=0, want_int8=10 * 48 * 11,
                    profile="a warm W8A8 distilled run")
    finally:
        attention.flash_attention = flash
    del w8
    torch.cuda.empty_cache()

    q, k, v = captured[0]
    ops, plain_ops = fa.int8_attention_prologue(q, k, v, 128**-0.5), fa.int8_attention_operands(q, k, v, 128**-0.5)
    unequal = [name for name in INT8_FIELDS if not torch.equal(getattr(ops, name), getattr(plain_ops, name))]
    print(f"  K6's CUDA prologue vs the plain one on the recorded q, k, v: fields unequal {unequal or 'none'}",
          flush=True)
    if unequal:
        fail(f"the CUDA prologue's {', '.join(unequal)} differ from the plain prologue's on the W8A8 run's q, k, v")
    ref = fa.flash_attention_int8_reference(q, k, v)
    out = fa.flash_attention_int8(q, k, v)
    err, l2 = (out.float() - ref.float()).abs().max().item(), rel_l2(out, ref)
    print(f"  K6 vs plain on the recorded q, k, v of stage 2, block 0: max|d o| {err:.3e} rel L2 {l2:.3e}", flush=True)
    if not (err <= 2e-2 and l2 <= 1e-3):
        fail("K6 disagrees with its plain version on the W8A8 run's q, k, v")
    fa.int8_launch_count = fa.int8_prologue_launch_count = 0
    worst = max(rel_l2(fa.flash_attention_int8(q, k, v), fa.flash_attention(q, k, v)) for q, k, v in captured)
    launches, prologues = fa.int8_launch_count, fa.int8_prologue_launch_count
    print(f"  K6 on the {len(captured)} attn1 calls of the first stage-2 step ({tuple(q.shape)}): {launches} "
          f"launches, {prologues} CUDA prologues; worst rel L2 against K1 {worst:.3e} (bar 5e-2)", flush=True)
    if launches != 48 or prologues != 48 or not worst < 5e-2:
        fail(f"K6 on the W8A8 run's q, k, v: {launches} launches, {prologues} prologues, rel L2 {worst:.3e} "
             "against K1")
    return {"k6": launches, "k6_prologue": prologues, "k6_vs_k1": worst}


def full_width_text_encoder(models, fa, qmm, work: Path, precompute=None) -> dict:
    """Phase 9b: the Gemma-3-12B geometry and the connectors, seeded bf16, on
    1024 left-padded token ids (128 real); the embeddings drive a distilled
    run to an mp4; then ``precompute(te, cfg)`` (phase 13 (a)) on the bf16
    encoder; then the same encoder in W8A8."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, init_gemma3_params
    from mlx_video_tpu_torch.models.ltx.text_encoder import encode_tokens, init_text_encoder_params
    from mlx_video_tpu_torch.ops import int8 as i8
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning

    cfg, dev, bf16 = Gemma3TextConfig(), torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    te = init_text_encoder_params(cfg, g, cfg.hidden_size, device=dev, dtype=bf16,
                                  language_model=init_gemma3_params(cfg, g, device=dev, dtype=bf16))
    for conn in (te.video_embeddings_connector, te.audio_embeddings_connector):
        conn.learnable_registers.normal_(generator=g)
    torch.cuda.synchronize()
    n_lm = sum(p.numel() for p in te.language_model.parameters())
    print(f"  Gemma-3-12B geometry drawn on the card in {time.perf_counter() - t0:.2f} s: language model "
          f"{n_lm / 1e9:.3f} B params, connectors and extractor {(sum(p.numel() for p in te.parameters()) - n_lm) / 1e9:.3f} "
          f"B; device memory {torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    mask = torch.zeros(1, 1024, dtype=torch.long, device=dev)
    mask[:, -128:] = 1
    ids = torch.randint(1, cfg.vocab_size, (1, 1024), generator=g, device=dev) * mask  # pad id 0, left

    def encode(label):
        out = None
        for _ in range(2):  # the second is warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            i8.int8_matmul_count = 0
            t = time.perf_counter()
            with torch.no_grad():
                out = encode_tokens(te, cfg, ids, mask)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        peak, want = torch.cuda.max_memory_allocated(), (48 * 7 + 1 if label == "W8A8" else 0)
        print(f"  encode_tokens {label}: {secs:.4f} s warm; peak device memory {peak / 2**30:.3f} GiB; "
              f"int8 products {i8.int8_matmul_count}; video {tuple(out[0].shape)}, audio {tuple(out[1].shape)}",
              flush=True)
        if any(o.shape != (1, 1024, models.transformer_config.caption_channels) or not torch.isfinite(o).all()
               for o in out):
            fail(f"{label} embeddings are not finite (1, 1024, caption channels)")
        if i8.int8_matmul_count != want:
            fail(f"{i8.int8_matmul_count} int8 products in a {label} encode, want {want}")
        with profiled(f"a warm {label} encode"), torch.no_grad():
            encode_tokens(te, cfg, ids, mask)
        return out, secs, peak

    (video, _), secs, peak = encode("bf16")
    mp4 = work / "from_token_ids.mp4"
    run = drive_slice(models, TextConditioning(video), fa, qmm, want_k2=0, output_path=mp4)
    if run["video_path"] is None or not Path(run["video_path"]).is_file() or Path(run["video_path"]).stat().st_size == 0:
        fail("the run from token ids wrote no mp4")
    print(f"  token ids -> embeddings -> distilled run -> {Path(run['video_path']).name}: "
          f"{Path(run['video_path']).stat().st_size} bytes", flush=True)
    if precompute is not None:
        precompute(te, cfg)
    t0 = time.perf_counter()
    i8.quantize_text_encoder_w8a8(te)
    torch.cuda.synchronize()
    print(f"  text encoder to W8A8 in place in {time.perf_counter() - t0:.2f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    (video8, audio8), secs8, peak8 = encode("W8A8")
    l2 = rel_l2(video8, video)
    print(f"  W8A8 video embeddings against bf16: rel L2 {l2:.3e}", flush=True)
    if not np.isfinite(l2):
        fail("W8A8 embeddings are not finite")
    del te, video, video8, audio8
    torch.cuda.empty_cache()
    return {"bf16_s": secs, "w8a8_s": secs8, "bf16_peak": peak, "w8a8_peak": peak8, "l2": l2}


# Phase 13: training data and audio-video training.
AV_DATA_SOURCES = {"latents": "latents", "conditions": "conditions", "audio_latents": "audio_latents"}


def av_waveform(stem: str, samples: int) -> "np.ndarray":
    """A seeded 2-channel waveform in [-1, 1] (two tones and noise), seeded
    by the clip's name."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(stem.encode()))
    t = np.arange(samples) / AV_SAMPLE_RATE
    tones = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
    return np.clip(0.4 * tones + 0.1 * rng.standard_normal(tones.shape), -1, 1).astype(np.float32)


def seeded_prompt_encoder(te, te_cfg, device, length: int = 1024, real: int = 128):
    """prompt -> (video, audio) embeddings from encode_tokens on ``length``
    left-padded token ids (``real`` of them drawn, seeded by the prompt):
    the text encoder as precompute calls it, where there is no tokenizer."""
    import zlib

    import torch

    from mlx_video_tpu_torch.models.ltx.text_encoder import encode_tokens

    def encode(prompt: str):
        g = torch.Generator().manual_seed(zlib.crc32(prompt.encode()))  # on the host: the same ids on any device
        mask = torch.zeros(1, length, dtype=torch.long)
        mask[:, -real:] = 1
        ids = torch.randint(1, te_cfg.vocab_size, (1, length), generator=g) * mask
        with torch.no_grad():
            return encode_tokens(te, te_cfg, ids.to(device), mask.to(device))

    return encode


def narrow_precompute_check(work: Path) -> None:
    """precompute_dataset on one seeded 96x64x9 clip (bucket 64x64x9, edge
    references, a seeded waveform): a narrow video encoder, a narrow audio
    encoder and phase 6a's tiny Gemma-3, bf16 on the card against fp32 on
    the CPU with the same weights. Bars: video and audio latents >= 35 dB
    per latent frame; embeddings relative L2 <= 2e-2 (phase 6a's)."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import VideoVAEConfig
    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, init_gemma3_params
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_encoder
    from mlx_video_tpu_torch.models.ltx.text_encoder import init_text_encoder_params
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
    from mlx_video_tpu_torch.trainer import precompute as pre

    te_cfg = Gemma3TextConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                              num_attention_heads=4, num_key_value_heads=2, head_dim=64, sliding_window=16,
                              sliding_window_pattern=2)
    g = torch.Generator().manual_seed(53)
    te = init_text_encoder_params(te_cfg, g, 256, device="cpu", dtype=torch.float32,
                                  language_model=init_gemma3_params(te_cfg, g, device="cpu", dtype=torch.float32))
    for conn in (te.video_embeddings_connector, te.audio_embeddings_connector):
        conn.learnable_registers.data.normal_(generator=g)
    vcfg, acfg = VideoVAEConfig(encoder_blocks=NARROW_ENCODER_BLOCKS), AudioVAEConfig(ch=32)
    venc, aenc = init_video_encoder(g, vcfg, device="cpu"), init_audio_encoder(g, acfg, device="cpu",
                                                                                dtype=torch.float32)
    with torch.no_grad():
        venc.per_channel_statistics.mean.normal_(generator=g).mul_(0.1)
        venc.per_channel_statistics.std.uniform_(0.7, 1.3, generator=g)
        aenc.per_channel_statistics.mean_of_means.normal_(generator=g).mul_(0.1)
        aenc.per_channel_statistics.std_of_means.uniform_(0.7, 1.3, generator=g)
    clips = work / "narrow_clips"
    clips.mkdir()
    write_clip(clips / "narrow.mp4", 9, 96, 54, height=64)
    processor = pre.audio_processor_for(acfg)
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        v = init_video_encoder(torch.Generator(device=device), vcfg, device=device, dtype=dtype)
        a = init_audio_encoder(torch.Generator(device=device), acfg, device=device, dtype=dtype)
        v.load_state_dict(venc.state_dict())
        a.load_state_dict(aenc.state_dict())  # convs in dtype, statistics fp32
        t = to_card(te, device, dtype)
        outs[device] = work / f"narrow_{device}"
        pre.precompute_dataset(
            [clips / "narrow.mp4"], outs[device], pre.make_video_encode_fn(v, vcfg),
            text_encode_fn=pre.make_text_encode_fn(seeded_prompt_encoder(t, te_cfg, device, 64, 40)),
            prompts={"narrow": "a narrow clip"}, buckets=pre.parse_buckets("64x64x9"),
            audio_encode_fn=lambda path: pre.encode_waveform(a, acfg, processor, av_waveform(path.stem, 6000),
                                                             AV_SAMPLE_RATE),
            reference_fn=pre.compute_edge_reference)
        del v, a, t

    def read(device, sub, name):
        with SafetensorsReader(outs[device] / sub / name) as r:
            return {k: r.get(k).float().numpy() for k in r.keys()}

    line, ok = "  narrow precompute, bf16 on the card vs fp32 on the CPU:", True
    for sub, axis in (("latents", 1), ("reference_latents", 1), ("audio_latents", 1)):
        ref, got = read("cpu", sub, "latent_narrow.safetensors"), read("cuda", sub, "latent_narrow.safetensors")
        peak = float(np.abs(ref["latents"]).max())
        frames = [psnr(np.take(got["latents"], i, axis), np.take(ref["latents"], i, axis), peak)
                  for i in range(ref["latents"].shape[axis])]
        finite = bool(np.isfinite(got["latents"]).all())
        line += f" {sub} min per-frame PSNR {min(frames):.2f} dB over {len(frames)} frames;"
        ok = ok and finite and min(frames) >= 35.0
    ref, got = (read(d, "conditions", "condition_narrow.safetensors") for d in ("cpu", "cuda"))
    for key in ("video_prompt_embeds", "audio_prompt_embeds"):
        l2 = float(np.linalg.norm(got[key] - ref[key]) / np.linalg.norm(ref[key]))
        line += f" {key} rel L2 {l2:.3e};"
        ok = ok and l2 <= 2e-2 and bool(np.isfinite(got[key]).all())
    print(line + " bars 35 dB and 2e-2", flush=True)
    if not ok:
        fail("the narrow precompute on the card disagrees with the CPU")


def full_width_precompute(models, te, te_cfg, work: Path) -> Path:
    """Phase 13 (a): precompute_dataset at full width on 2 seeded 65-frame
    832x544 clips (cv2, mp4v) bucketed to 768x512x65: the seeded default
    video VAE encoder of phase 7a, phase 9b's text encoder on seeded token
    ids, the default audio VAE encoder (seeded bf16) on a seeded waveform
    of each clip's duration, Canny edge references. Returns the dataset's
    root; every clip must have each of its four files."""
    import numpy as np
    import torch

    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_encoder
    from mlx_video_tpu_torch.trainer import precompute as pre

    dev = torch.device("cuda")
    narrow_precompute_check(work)
    clips = work / "av_clips"
    clips.mkdir()
    stems = [f"clip_{i:03d}" for i in range(2)]
    for i, stem in enumerate(stems):
        write_clip(clips / f"{stem}.mp4", AV_CLIP_FRAMES, AV_CLIP_SIZE[0], 55 + i, height=AV_CLIP_SIZE[1])
    g = torch.Generator(device=dev).manual_seed(56)
    acfg = AudioVAEConfig()
    aenc = init_audio_encoder(g, acfg, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        aenc.per_channel_statistics.mean_of_means.normal_(generator=g).mul_(0.1)
        aenc.per_channel_statistics.std_of_means.uniform_(0.7, 1.3, generator=g)
    processor = pre.audio_processor_for(acfg)

    def audio_encode(path: Path):
        # the card machine has no ffmpeg, so extract_audio_pcm finds no track: a seeded waveform stands in
        return pre.encode_waveform(aenc, acfg, processor, av_waveform(path.stem, AV_CLIP_SAMPLES), AV_SAMPLE_RATE)

    out = work / "av_data"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = pre.precompute_dataset(
        sorted(clips.iterdir()), out, pre.make_video_encode_fn(models.vae_encoder, models.vae_encoder_config),
        text_encode_fn=pre.make_text_encode_fn(seeded_prompt_encoder(te, te_cfg, dev)),
        prompts={stem: f"seeded clip {stem}" for stem in stems}, buckets=pre.parse_buckets("768x512x65"),
        audio_encode_fn=audio_encode, reference_fn=pre.compute_edge_reference)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  precompute_dataset: {n} clips in {secs:.2f} s ({secs / max(n, 1):.2f} s a clip: two video encodes, "
          f"one text and one audio encode each); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; ffmpeg on this machine: {shutil.which('ffmpeg') is not None}", flush=True)
    want = {("latents", "latent"): {"latents": (128, 9, 16, 24)},
            ("reference_latents", "latent"): {"latents": (128, 9, 16, 24)},
            ("conditions", "condition"): {"video_prompt_embeds": (1024, 3840), "audio_prompt_embeds": (1024, 3840),
                                          "prompt_attention_mask": (1024,)},
            ("audio_latents", "latent"): {"latents": (8, AV_TRAIN_T, 16), "num_time_steps": (1,)}}
    for stem in stems:
        for (sub, prefix), shapes in want.items():
            path = out / sub / f"{prefix}_{stem}.safetensors"
            if not path.is_file():
                fail(f"precompute wrote no {sub} for {stem}")
            with SafetensorsReader(path) as r:
                got = {k: r.get(k) for k in r.keys()}
            for key, shape in shapes.items():
                if key not in got or tuple(got[key].shape) != shape:
                    fail(f"{path.name} in {sub}: {key} {tuple(got[key].shape) if key in got else None}, want {shape}")
            if not all(torch.isfinite(t.float()).all() for t in got.values()):
                fail(f"{path.name} in {sub} is not finite")
            if sub == "audio_latents":
                if int(got["num_time_steps"][0]) != AV_TRAIN_T:
                    fail(f"{stem}: {int(got['num_time_steps'][0])} audio latent frames, want {AV_TRAIN_T}")
                print(f"  {stem}: audio latents {tuple(got['latents'].shape)}, {float(got['duration'][0]):.4f} s "
                      f"of audio; the video's {AV_CLIP_FRAMES / 24.0:.4f} s", flush=True)
    del aenc
    torch.cuda.empty_cache()
    return out


def av_lora_recipe(**kw):
    """ltx_trainer/configs/ltx2_av_lora.yaml as a TrainingConfig (rank 16,
    alpha 32, lr 5e-5, batch 1, seed 42, with_audio on audio_latents/, the
    trainer's defaults otherwise), with gradient checkpointing on."""
    from mlx_video_tpu_torch.trainer.config import TrainingConfig

    base = dict(training_mode="lora", lora_rank=16, lora_alpha=32.0, strategy="text_to_video", with_audio=True,
                audio_latents_dir="audio_latents", lr=5e-5, batch_size=1, seed=42,
                enable_gradient_checkpointing=True, handle_preemption=False)
    return TrainingConfig(**{**base, **kw})


def full_width_av_training(models, fa, qmm, data_root: Path, out_root: Path) -> dict:
    """Phase 13 (b): 4 AV LoRA steps on the 19B AudioVideo DiT (the bf16
    video DiT's modules plus phase 12's audio tensors, drawn again) over (a)'s
    files, a ValidationSampler at step 0 and after step 2; then a resume from
    state_step_2 without validation, and a profiled warm step."""
    import dataclasses

    import torch

    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning
    from mlx_video_tpu_torch.trainer.trainer import Trainer
    from mlx_video_tpu_torch.trainer.validation_sampler import ValidationSampler

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    av, av_cfg = audio_video_model(models.transformer)
    with SafetensorsReader(data_root / "conditions" / "condition_clip_000.safetensors") as r:
        text = TextConditioning(r.get("video_prompt_embeds")[None].to(dev, torch.bfloat16))
    sampler = ValidationSampler(dataclasses.replace(models, transformer_config=av_cfg),
                                output_dir=out_root / "validation", prompts=["seeded clip clip_000"], width=512,
                                height=512, num_frames=33, steps=8, seed=57, precomputed_text=text)
    val_k1 = []

    def validate(model, step):
        before, t0 = fa.launch_count, time.perf_counter()
        (path,) = sampler(model, step)
        val_k1.append(fa.launch_count - before)
        print(f"  validation at step {step}: {time.perf_counter() - t0:.2f} s, {val_k1[-1]} K1, {path.name} "
              f"{path.stat().st_size if path.is_file() else 0} bytes", flush=True)
        if not path.is_file() or path.stat().st_size == 0:
            fail(f"validation at step {step} wrote no mp4")

    out = out_root / "av"
    cfg = av_lora_recipe(steps=4, save_every=2, output_dir=str(out), data_root=str(data_root), validation_interval=2)
    trainer = Trainer(cfg, model_config=av_cfg, params=av, validation_fn=validate)
    if trainer.dataset.data_sources != AV_DATA_SOURCES:
        fail(f"the AV Trainer reads {trainer.dataset.data_sources}, want {AV_DATA_SOURCES}")
    print(f"  AV Trainer set up in {time.perf_counter() - t_phase:.2f} s: {len(trainer.params)} LoRA tensors, "
          f"{sum(p.numel() for p in trainer.params.values()) / 1e6:.3f} M parameters", flush=True)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with launch_shapes(fa, qmm) as shapes:
        fa.launch_count = fa.bwd_launch_count = 0
        t0 = time.perf_counter()
        trainer.train()
        wall = time.perf_counter() - t0
        k1, k3 = fa.launch_count - sum(val_k1), fa.bwd_launch_count
    peak = torch.cuda.max_memory_allocated()
    losses, secs = list(trainer.loss_history), list(trainer.step_seconds)
    tokens = 3456 + AV_TRAIN_T
    norms = {kind: sum(p.float().norm().item() for n, p in trainer.params.items()
                       if n.endswith("lora_B") and (".audio_" in n or "_to_" in n) == (kind == "audio"))
             for kind in ("video", "audio")}
    print(f"  losses {['%.6f' % x for x in losses]}; step seconds {['%.4f' % x for x in secs]} (steps 0 and 2 "
          f"include no validation: it runs before a step's timer and after its update); tokens/s after the first "
          f"step {tokens * (len(secs) - 1) / sum(secs[1:]):.1f} ({tokens} a step: 3456 video, {AV_TRAIN_T} audio)",
          flush=True)
    print(f"  train wall {wall:.4f} s (saves and 2 validations included); device memory {base_mem / 2**30:.3f} GiB "
          f"before, peak {peak / 2**30:.3f} GiB; launches K1 {k1} (+{sum(val_k1)} in validation), K3 {k3}; sum of "
          f"LoRA B norms: video {norms['video']:.4e}, audio and cross-modal {norms['audio']:.4e}", flush=True)
    check_compared(shapes, "phase 13 (b)")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"AV training losses {losses}")
    if not (norms["video"] > 0 and norms["audio"] > 0):
        fail(f"the LoRA B factors did not move: {norms}")
    if (k1, k3) != (4 * 192, 4 * 96) or val_k1 != [528, 528]:
        fail(f"{k1} K1 and {k3} K3 launches in 4 AV steps, want {4 * 192} and {4 * 96}; validation K1 {val_k1}, "
             "want [528, 528]")
    with SafetensorsReader(out / "lora_step_4.safetensors") as r:
        keys = set(r.keys())
    attns = ("attn1", "attn2", "audio_attn1", "audio_attn2", "audio_to_video_attn", "video_to_audio_attn")
    mods = [f"{a}.{lin}" for a in attns for lin in ("to_q", "to_k", "to_v", "to_out")] + [
        "ff.proj_in", "ff.proj_out", "audio_ff.proj_in", "audio_ff.proj_out"]
    want = {f"diffusion_model.transformer_blocks.{i}.{m}.lora_{ab}.weight" for i in range(48) for m in mods
            for ab in "AB"}
    if keys != want:
        fail(f"AV adapter keys differ from the reference format: {sorted(keys ^ want)[:5]}")
    print(f"  lora_step_4.safetensors: {len(keys)} reference keys (28 linears a block); files "
          f"{sorted(p.name for p in out.iterdir())}", flush=True)
    del trainer

    resume_dir = out_root / "av_resume"
    resume_dir.mkdir()
    shutil.copy(out / "state_step_2.safetensors", resume_dir)
    resumed = Trainer(av_lora_recipe(steps=4, save_every=2, output_dir=str(resume_dir), data_root=str(data_root),
                                     resume=True), model_config=av_cfg, params=av)
    if resumed.start_step != 2:
        fail(f"the AV run resumed at step {resumed.start_step}, want 2")
    resumed.train()
    again = list(resumed.loss_history)
    print(f"  resumed from state_step_2 without validation: losses of steps 2, 3 {['%.6f' % x for x in again]} vs "
          f"{['%.6f' % x for x in losses[2:]]}", flush=True)
    if again != losses[2:]:
        fail("the resumed AV run's losses differ from the validated run's")
    profile_lora_step(resumed, fa, tokens=tokens)
    del resumed
    strip_lora(av)
    for p in av.parameters():
        p.requires_grad_(False)
    del av
    torch.cuda.empty_cache()
    print(f"  phase 13 (b): {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"k1": k1, "k3": k3, "k1_validation": val_k1[0], "step_seconds": secs, "peak_gib": peak / 2**30}


def quantize_full_width(models) -> None:
    import torch

    from mlx_video_tpu_torch.ops.linear import QuantLinear
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_dit_params(models.transformer, group_size=64, bits=4, scope="core")  # in place
    torch.cuda.synchronize()
    n = sum(isinstance(m, QuantLinear) for m in models.transformer.modules())
    print(f"  quantized in place in {time.perf_counter() - t0:.2f} s: {n} QuantLinears; device memory "
          f"{before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    if n != 10 * 48:
        fail(f"{n} quantized linears, want {10 * 48}")


def full_width_w4a8(models, text, fa, qmm) -> None:
    """W4A8 on the q4 DiT of phase 9 (quantize_models --w4a8: int8 scales
    from the group endpoints, no K2), the distilled run, then the scales are
    taken off so the q4 model goes on as it was."""
    import torch

    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.ops.linear import QuantLinear

    t0 = time.perf_counter()
    loading.quantize_models(models, None, w4a8=True)
    torch.cuda.synchronize()
    layers = [m for m in models.transformer.modules() if isinstance(m, QuantLinear)]
    print(f"  prepare_w4a8 in {time.perf_counter() - t0:.3f} s: {len(layers)} quantized linears with int8 scales",
          flush=True)
    drive_slice(models, text, fa, qmm, want_k2=0, want_int8=10 * 48 * 11, profile="a warm W4A8 distilled run")
    for m in layers:
        del m._buffers["int8_scale"]


def mlx_key(name: str) -> str:
    """Port DiT state name -> sanitized MLX key (packed words under .weight):
    the inverse of io/weights.py's mapping, for writing a snapshot."""
    head, _, rest = name.partition(".")
    key = {"blocks": "transformer_blocks." + rest, "video": rest, "audio": "audio_" + rest}.get(head)
    if head == "av":  # av.<adaln>.x -> <adaln>_single.x
        adaln, _, leaf = rest.partition(".")
        key = f"{adaln}_single.{leaf}"
    return key[: -len("quant_weight")] + "weight" if key.endswith(".quant_weight") else key


def audio_decoder_key(name: str) -> str:
    """Port audio decoder state name -> checkpoint key: ``decoder.``, the
    convs of CausalConv2d wrappers one level deeper, the statistics under
    their own prefix and the reference's hyphenated names."""
    if name.startswith("per_channel_statistics."):
        return name.replace("_of_", "-of-")
    parts = name.split(".")
    if parts[-2] in ("conv1", "conv2", "nin_shortcut", "conv_in", "conv_out", "conv"):
        parts.insert(len(parts) - 1, "conv")
    return "decoder." + ".".join(parts)


def decoder_key(name: str) -> str:
    """Port decoder state name -> checkpoint key (the inverse of
    io/vae_weights.py's remap, with the CausalConv .conv nesting)."""
    if name == "latents_mean":
        return "per_channel_statistics.mean-of-means"
    if name == "latents_std":
        return "per_channel_statistics.std-of-means"
    parts = name.split(".")
    if parts[0] == "up_blocks":
        i, rest = int(parts[1]), parts[2:]
        if rest[0] == "res_blocks":
            rest = ["resnets"] + rest[1:]
        if i == 0:
            parts = ["mid_block"] + rest
        elif i % 2 == 0:
            parts = ["up_blocks", str(i // 2 - 1)] + rest
        else:
            parts = ["up_blocks", str(i // 2), "upsamplers", "0"] + rest
    if len(parts) >= 2 and parts[-2] in ("conv1", "conv2", "conv_in", "conv_out"):
        parts = parts[:-1] + ["conv", parts[-1]]
    key = ".".join(parts)
    return key if key.startswith("per_channel") else "decoder." + key


def snapshot_and_cli(models, text, fa, qmm, data_root: Path, cond: dict, av_data: Path) -> dict:
    """Write the q4 model as an MLX pre-quantized snapshot (with the seeded
    encoder in its VAE file), load it back, run the generate CLI on it
    (distilled, --w4a8, and phase 11's keyframe run: ``cond`` holds its
    images and adapter), then the training CLI over its 4-bit file, and
    again with --with-audio over ``av_data`` (phase 13 (c))."""
    import torch

    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.cli import generate as cli
    from mlx_video_tpu_torch.io.safetensors import save_safetensors
    from mlx_video_tpu_torch.ops import int8 as i8
    from mlx_video_tpu_torch.ops.linear import QuantLinear
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params

    # phase 12 (d): the snapshot's DiT file is an AudioVideo one, phase 12's
    # audio tensors drawn again on the q4 video modules and their audio and
    # cross-modal linears quantized in the core scope
    t0 = time.perf_counter()
    av, _ = audio_video_model(models.transformer)
    quantize_dit_params(av, group_size=64, bits=4, scope="core")
    n_quant = sum(isinstance(m, QuantLinear) for m in av.modules())
    decoders = audio_decoders(models.transformer.video.scale_shift_table.device)
    torch.cuda.synchronize()
    print(f"  the AudioVideo DiT on the q4 video modules, its audio and cross-modal linears quantized: {n_quant} "
          f"QuantLinears in {time.perf_counter() - t0:.2f} s", flush=True)
    if n_quant != 28 * 48:
        fail(f"{n_quant} quantized linears in the AudioVideo DiT, want {28 * 48}")
    files = {
        "ltx-2-19b-distilled-4bit-mlx.safetensors": {
            mlx_key(k): v.view(torch.uint32) if k.endswith(".quant_weight") else v
            for k, v in av.state_dict().items()
        },
        "vae/diffusion_pytorch_model.safetensors": {
            **{decoder_key(k): v for k, v in models.vae_decoder.state_dict().items()},
            **{f"encoder.{k}": v for k, v in models.vae_encoder.state_dict().items()},
        },
        loading.UPSAMPLER_FILE: dict(models.upsampler.state_dict()),
        "audio_vae/diffusion_pytorch_model.safetensors": {
            audio_decoder_key(k): v for k, v in decoders["audio_decoder"].state_dict().items()},
        "vocoder/diffusion_pytorch_model.safetensors": dict(decoders["vocoder"].state_dict()),
    }
    need = sum(t.numel() * t.element_size() for f in files.values() for t in f.values())
    roots = [Path(tempfile.gettempdir()), Path(__file__).resolve().parent]
    free = {root: shutil.disk_usage(root).free for root in roots}
    print("  free disk: " + ", ".join(f"{r} {b / 2**30:.1f} GiB" for r, b in free.items())
          + f"; the snapshot needs {need / 2**30:.2f} GiB", flush=True)
    root = max(roots, key=free.get)
    if free[root] < 1.2 * need + 2**30:
        fail(f"no directory with {need / 2**30:.2f} GiB free for the snapshot")
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=root))
    try:
        snap = tmp / "ltx2-distilled-4bit-mlx"
        t0 = time.perf_counter()
        for name, tensors in files.items():
            (snap / name).parent.mkdir(parents=True, exist_ok=True)
            save_safetensors(snap / name, tensors)
        embeddings = tmp / "embeddings.safetensors"
        g = torch.Generator(device="cuda").manual_seed(47)
        save_safetensors(embeddings, {"video_prompt_embeds": text.video_embeddings[0], **{
            name: torch.randn(128, 3840, generator=g, device="cuda").bfloat16() for name in ("audio", "audio_neg")}})
        print(f"  wrote the snapshot (an AudioVideo DiT file, audio_vae/, vocoder/) to {root} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del files

        t0 = time.perf_counter()
        bundle = loading.load_model_bundle(snap, bits_hint=loading.bits_hint_for(str(snap)), load_encoder=True,
                                           audio=True, audio_mode="joint", device="cuda")
        torch.cuda.synchronize()
        print(f"  load_model_bundle (audio, joint: the AudioVideo DiT): {time.perf_counter() - t0:.2f} s", flush=True)
        n = 0
        ref = dict(transformer=av, **decoders)
        for part in ("transformer", "vae_decoder", "upsampler", "vae_encoder", "audio_decoder", "vocoder"):
            want = (ref[part] if part in ref else getattr(models, part)).state_dict()
            got = getattr(bundle, part).state_dict()
            if set(want) != set(got):
                fail(f"loaded {part} has other tensors: {sorted(set(want) ^ set(got))[:10]}")
            bad = [k for k in want if want[k].dtype != got[k].dtype or not torch.equal(want[k], got[k])]
            if bad:
                fail(f"loaded {part} differs from the in-memory one at {bad[:10]}")
            n += len(want)
        print(f"  the loaded snapshot equals the in-memory model: {n} tensors, torch.equal", flush=True)
        del bundle, av, decoders, ref
        torch.cuda.empty_cache()

        has_ffmpeg, has_cv2 = shutil.which("ffmpeg") is not None, importlib.util.find_spec("cv2") is not None
        output, report = tmp / "out.mp4", tmp / "phases.json"
        argv = ["--prompt", "synthetic embeddings", "--checkpoint-path", str(snap), "--embeddings", str(embeddings),
                "--height", "512", "--width", "512", "--num-frames", "33", "--seed", "1",
                "--output-path", str(output), "--profile-json-path", str(report), "--device", "cuda"]
        print(f"  video writers on this machine: ffmpeg {has_ffmpeg}, cv2 {has_cv2}", flush=True)
        if not (has_ffmpeg or has_cv2):
            argv.append("--latents-only")
            print("  neither ffmpeg nor cv2 is here: the CLI runs with --latents-only (the mp4 write is "
                  "tested on the CPU)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        fa.launch_count = fa.bwd_launch_count = qmm.launch_count = 0
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
        k1, k2 = fa.launch_count, qmm.launch_count
        phases = json.loads(report.read_text())["phases"]
        for name, sec in phases.items():
            print(f"  CLI phase {name}: {sec:.4f} s", flush=True)
        print(f"  CLI main wall {wall:.4f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}", flush=True)
        if "--latents-only" not in argv:
            if not output.is_file() or output.stat().st_size == 0:
                fail(f"the CLI wrote no video at {output}")
            print(f"  CLI wrote {output.name}: {output.stat().st_size} bytes", flush=True)
        check_launches(k1, k2, 10 * 48 * (8 + 3))
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        fa.launch_count = qmm.launch_count = i8.int8_matmul_count = 0
        t0 = time.perf_counter()
        cli.main([*argv, "--w4a8"])
        wall = time.perf_counter() - t0
        k1, k2, int8 = fa.launch_count, qmm.launch_count, i8.int8_matmul_count
        for name, sec in json.loads(report.read_text())["phases"].items():
            print(f"  CLI --w4a8 phase {name}: {sec:.4f} s", flush=True)
        print(f"  CLI --w4a8 main wall {wall:.4f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}; int8 products {int8}",
              flush=True)
        check_launches(k1, k2, 0, int8, 10 * 48 * (8 + 3))
        torch.cuda.empty_cache()

        # phase 11 (g): the keyframe pipeline through the CLI, a 4-bit stage-2 model, streamed, with --lora
        images = [arg for path, idx, strength in cond["keyframes"] for arg in ("--image", path, str(idx), str(strength))]
        argv_g = [*argv[:argv.index("--output-path")], "--pipeline", "keyframe", *images, "--stage2-model-repo",
                  str(snap), "--stream", "--lora", str(cond["adapter"]), "--output-path", str(tmp / "keyframe.mp4"),
                  "--profile-json-path", str(report), "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        fa.launch_count = qmm.launch_count = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main(argv_g)
        finally:
            print("  " + out.getvalue().strip().replace("\n", "\n  "), flush=True)
        wall = time.perf_counter() - t0
        k1, k2 = fa.launch_count, qmm.launch_count
        for name, sec in json.loads(report.read_text())["phases"].items():
            print(f"  CLI keyframe phase {name}: {sec:.4f} s", flush=True)
        print(f"  CLI --pipeline keyframe --image x2 --stage2-model-repo --stream --lora: main wall {wall:.4f} s; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}",
              flush=True)
        if f"applied=0 skipped={cond['pairs']}" not in out.getvalue():
            fail(f"(g) the CLI's --lora over the 4-bit base did not skip its {cond['pairs']} pairs")
        if not (tmp / "keyframe.mp4").is_file() or (tmp / "keyframe.mp4").stat().st_size == 0:
            fail("(g) the CLI wrote no keyframe.mp4")
        check_launches(k1, k2, 10 * 48 * (8 + 3))
        torch.cuda.empty_cache()
        audio = audio_cli(argv, snap, tmp, fa, qmm)
        q4_file = snap / "ltx-2-19b-distilled-4bit-mlx.safetensors"
        return {"k2_keyframe_cli": k2, "k1_keyframe_cli": k1, **audio,
                **train_cli_over_q4(q4_file, data_root, tmp / "train", fa, qmm),
                **train_cli_over_q4(q4_file, av_data, tmp / "train_av", fa, qmm, audio=True)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def audio_cli(argv: list, snap: Path, tmp: Path, fa, qmm) -> dict:
    """Phase 12 (d): the generate CLI with --audio on the AudioVideo 4-bit
    snapshot: joint (28 linears a block on K2: 10 video, 18 audio and
    cross-modal), then separate with --audio-model-repo at a directory whose
    ltx-2-19b-distilled-mlx.safetensors is the same file (the VideoOnly DiT's
    10 a block over 11 steps, the AudioOnly DiT's 10 a block over 8 steps at
    B = 2)."""
    import torch

    from mlx_video_tpu_torch.cli import generate as cli

    audio_repo = tmp / "audio_repo"
    audio_repo.mkdir()
    (audio_repo / "ltx-2-19b-distilled-mlx.safetensors").symlink_to(snap / "ltx-2-19b-distilled-4bit-mlx.safetensors")
    base = argv[:argv.index("--output-path")]
    t = audio_frames_for(33)
    out = {}
    with launch_shapes(fa, qmm) as shapes:
        for mode, flags, want in (
                ("joint", ["--audio", "--audio-mode", "joint"], (2 * 48 * 11, 28 * 48 * 11)),
                ("separate", ["--audio", "--audio-model-repo", str(audio_repo)],
                 (48 * 11 + 48 * 8, 10 * 48 * 11 + 10 * 48 * 8))):
            video, report = tmp / f"audio_{mode}.mp4", tmp / f"audio_{mode}.json"
            torch.cuda.reset_peak_memory_stats()
            fa.launch_count = qmm.launch_count = 0
            t0 = time.perf_counter()
            cli.main([*base, *flags, "--output-path", str(video), "--profile-json-path", str(report),
                      "--device", "cuda"])
            wall = time.perf_counter() - t0
            k1, k2 = fa.launch_count, qmm.launch_count
            for name, sec in json.loads(report.read_text())["phases"].items():
                print(f"  CLI --audio ({mode}) phase {name}: {sec:.4f} s", flush=True)
            print(f"  CLI --audio ({mode}) main wall {wall:.4f} s; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}", flush=True)
            if (k1, k2) != want:
                fail(f"CLI --audio ({mode}): launches K1 {k1}, K2 {k2}; want {want}")
            check_wav(video.with_suffix(".wav"), t, f"CLI --audio ({mode})")
            check_mp4_audio(video, f"CLI --audio ({mode})")
            out.update({f"k1_audio_{mode}_cli": k1, f"k2_audio_{mode}_cli": k2})
            torch.cuda.empty_cache()
    check_compared(shapes, "phase 12 (d)")
    return out


def train_cli_over_q4(q4_file: Path, data_root: Path, out: Path, fa, qmm, audio: bool = False) -> dict:
    """python -m mlx_video_tpu_torch.train, in-process: LoRA over the frozen
    4-bit base read from the snapshot file, 2 steps: the ltx2_lora.yaml
    recipe on phase 8's dataset, or with ``audio`` the ltx2_av_lora.yaml
    recipe (--with-audio, the AudioVideo DiT of the same file) on phase 13
    (a)'s files, its K1, K3 and K2 launches recorded by shape."""
    import torch

    from mlx_video_tpu_torch.cli import train as train_cli

    recipe = (["--lora-rank", "16", "--lora-alpha", "32", "--lr", "5e-5", "--with-audio", "--audio-latents-dir",
               "audio_latents"] if audio else
              ["--lora-rank", "8", "--lora-alpha", "16", "--lr", "1e-4", "--scheduler-type", "cosine",
               "--timestep-sampling-mode", "shifted_logit_normal", "--first-frame-conditioning-p", "0.1"])
    argv = ["--model-repo", str(q4_file), "--training-mode", "lora", "--data-root", str(data_root),
            "--steps", "2", *recipe, "--max-grad-norm", "1.0", "--seed", "42", "--output-dir", str(out),
            "--enable-gradient-checkpointing", "--device", "cuda"]
    what = "AV training CLI (--with-audio)" if audio else "training CLI"
    torch.cuda.reset_peak_memory_stats()
    with launch_shapes(fa, qmm) as shapes:
        fa.launch_count = fa.bwd_launch_count = qmm.launch_count = 0
        t0 = time.perf_counter()
        train_cli.main(argv)
        wall = time.perf_counter() - t0
        k1, k3, k2 = fa.launch_count, fa.bwd_launch_count, qmm.launch_count
    print(f"  {what} wall {wall:.4f} s (the 4-bit file's load included); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K3 {k3}, K2 {k2}; files "
          f"{sorted(p.name for p in out.iterdir())}", flush=True)
    streams, linears = (2, 28) if audio else (1, 10)
    want = (2 * 2 * 48 * streams, 2 * 48 * streams, 2 * 2 * linears * 48)
    if (k1, k3, k2) != want:
        fail(f"{what} launches K1 {k1}, K3 {k3}, K2 {k2}; want {want}")
    if not (out / "lora_step_2.safetensors").is_file():
        fail(f"the {what} wrote no lora_step_2.safetensors")
    check_compared(shapes, f"phase 13 (c), the {what}" if audio else f"phase 10, the {what}")
    tag = "_av_cli" if audio else ""
    return {f"k1{tag}": k1, f"k3{tag}": k3, f"k2{tag}": k2}


PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time for the work on the card, and which side binds."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_fwd_work(b: int, s: int, h: int, d: int):
    """softmax(q k^T) v with lse: two S x S x D products a head; q, k, v read,
    o (bf16) and lse (fp32) written."""
    return 4.0 * b * s * s * d * h, b * (4 * s * h * d * 2 + s * h * 4)


def attention_bwd_work(s: int, h: int, d: int):
    """dQ, dK, dV: the five S x S x D products a head that the gradients need
    (q k^T and dO v^T to rebuild p and dp, then dS k, dS^T q, p^T dO); q, k, v,
    o, dO and lse read, dq, dk, dv written."""
    return 10.0 * s * s * d * h, 8 * s * h * d * 2 + s * h * 4


def quant_matmul_work(m: int, k: int, n: int, bits: int, group: int):
    """x (M, K) bf16 times the packed (N, K) weight: 2 M K N operations; x,
    the words and the fp32 scales and biases read, y (bf16) written."""
    return 2.0 * m * k * n, m * k * 2 + n * k * bits // 8 + 2 * n * (k // group) * 4 + m * n * 2


def cross_attention_work(b: int, sq: int, skv: int, h: int, d: int, bias: bool):
    """softmax(q k^T + bias) v: two Sq x Skv x D products a head; q, k, v and
    the fp32 bias rows read, o (bf16) written."""
    return 4.0 * b * sq * skv * d * h, (2 * b * sq + 2 * b * skv) * h * d * 2 + (b * skv * 4 if bias else 0)


def rope_attention_work(b: int, s: int, h: int, d: int):
    """K1's products on rotated q and k; q, k, v and the fp32 (B, H, S, D/2)
    cos and sin tables read, o (bf16) written (no lse on the inference path)."""
    return 4.0 * b * s * s * d * h, 4 * b * s * h * d * 2 + 2 * b * h * s * (d // 2) * 4


def int8_attention_work(b: int, s: int, h: int, d: int):
    """K6: two S x S x D int8 products a head (pass 1's repeated q k^T is the
    kernel's overhead, not the function's work); int8 q, k, v read, o (bf16)
    written."""
    return 4.0 * b * s * s * d * h, 3 * b * s * h * d + 2 * b * s * h * d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mlx_video_tpu_torch.ops import _build
    from mlx_video_tpu_torch.ops import cross_attention as ca
    from mlx_video_tpu_torch.ops import flash_attention as fa
    from mlx_video_tpu_torch.ops import quant_matmul as qmm

    # fp32 references stay fp32 on the card (the bf16 path is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path().name})", flush=True)
    kernel = "?"
    for line in _build.build_log_path().read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_label(entry.group(1))
        if "registers" in line or "spill" in line:
            named = re.search(r"in function '(\S+)'", line)  # a note that names its kernel
            print(f"  ptxas: {kernel_label(named.group(1)) if named else kernel}: {line.strip()}", flush=True)

    k1 = kernel_vs_plain(fa)
    k2 = quant_kernel_vs_plain(qmm)
    k3 = bwd_kernel_vs_plain(fa)
    k4 = cross_kernel_vs_plain(ca)
    k5 = rope_kernel_vs_plain(fa)
    k6 = int8_kernel_vs_plain(fa)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        print("small slices, card vs CPU reference:", flush=True)
        small_slice_check("dense")
        small_slice_check("q4")
        lora_slice_check()
        narrow_dev_check(work)
        print("int8 slices at narrow width, card vs CPU reference:", flush=True)
        small_slice_check("w8a8")
        small_slice_check("w4a8")
        small_text_encoder_check()
        lora_slice_check(w4a8=True)
        print("audio at narrow width, card vs CPU reference:", flush=True)
        narrow_audio_check()
        lora_slice_check(audio=True)
        models, text = full_width_models()
        print("full-width distilled slice (512x512x33, 19B video DiT geometry, bf16):", flush=True)
        drive_slice(models, text, fa, qmm, want_k2=0, profile="a warm dense distilled run")
        print("full-width dev slice (768x768x65: 5184 tokens, 40 steps, CFG 4.5, one image; K4 and K5 routes on):",
              flush=True)
        dev = full_width_dev(models, fa, ca, work)
        print("full-width conditioned distilled slice (512x512x33, 8 + 3 steps; images, keyframes streamed, IC-LoRA, "
              "a LoRA-merged stage-2 copy, stage-2 CFG, two videos):", flush=True)
        cond = full_width_conditioned(models, text, fa, work)
        print("full-width audio slice (the 19B AudioVideo DiT: 32 x 128 video and 32 x 64 audio heads, bf16; the "
              "AudioOnly DiT on its audio tensors; the default audio VAE decoder and vocoder):", flush=True)
        with launch_shapes(fa, qmm) as shapes:
            audio = full_width_audio(models, text, fa, ca, work)
        check_compared(shapes, "phase 12 (a)-(c)")
        write_training_dataset(work / "data")
        print("full-width dense LoRA training (768x512x65: 3456 tokens, 19B video DiT geometry, bf16):", flush=True)
        train = full_width_training(models, fa, work / "data", work)
        print("full-width W8A8 slice (a W8A8 copy of the same DiT); K6 on its q, k, v:", flush=True)
        w8 = full_width_w8a8(models, text, fa, qmm)
        print("full-width text encoder (Gemma-3-12B geometry and the connectors, seeded bf16, then W8A8); phase 13 "
              "(a), full-width precompute (768x512x65 clips: video, caption and audio latents, edge references) on "
              "its bf16 encoder:", flush=True)
        av_data = []
        full_width_text_encoder(models, fa, qmm, work, precompute=lambda te, te_cfg: av_data.append(
            full_width_precompute(models, te, te_cfg, work)))
        (av_data,) = av_data
        print(f"full-width AV LoRA training (ltx2_av_lora.yaml, 768x512x65: 3456 video and {AV_TRAIN_T} audio tokens, "
              "the 19B AudioVideo DiT, bf16) with a ValidationSampler:", flush=True)
        av = full_width_av_training(models, fa, qmm, av_data, work)
        print("full-width q4 slice (the same DiT, 4 bits, group 64, core scope):", flush=True)
        quantize_full_width(models)
        drive_slice(models, text, fa, qmm, want_k2=10 * 48 * (8 + 3), profile="a warm q4 distilled run")
        print("full-width W4A8 slice (the q4 DiT, int8 products):", flush=True)
        full_width_w4a8(models, text, fa, qmm)
        print("MLX pre-quantized snapshot -> load_model_bundle -> generate CLI; training CLI over the 4-bit "
              "file:", flush=True)
        cli_train = snapshot_and_cli(models, text, fa, qmm, work / "data", cond, av_data)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    s_train = 3456
    k1_ms, k1_plain_ms, k1_lib_ms = k1["rows"][(1, s_train, 128)]
    k3_ms, k3_plain_ms, k3_lib_ms = k3["rows"][(s_train, 128)]
    k2_ms, k2_plain_ms = k2["rows"][K2_TRAIN_SHAPE]
    k4_ms, k4_plain_ms, k4_lib_ms, _ = k4["rows"][(2, 5184, 128, 128)]
    k5_ms, k5_plain_ms, _, _ = k5["rows"][(2, 5184)]
    k6_ms, k6_plain_ms, _, _, k6_prologue_ms = k6["rows"][(1, 1280, 128)]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:102",
        "launches": train["k1"],
        "path_launches": {"lora_training": train["k1"], "keyframe_cli": cli_train["k1_keyframe_cli"],
                          **{f"conditioned_{run}": n for run, n in cond["k1"].items()}, **audio["k1"],
                          "audio_joint_cli": cli_train["k1_audio_joint_cli"],
                          "audio_separate_cli": cli_train["k1_audio_separate_cli"],
                          "av_lora_training": av["k1"], "validation": av["k1_validation"],
                          "av_training_cli": cli_train["k1_av_cli"]},
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        **bound(*attention_fwd_work(1, s_train, 32, 128)),
        "library_ms": k1_lib_ms,
    }, {
        "name": "quant_matmul",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "mlx_video_tpu/ops/quant_matmul.py:87",
        "launches": cli_train["k2"],
        "path_launches": {"training_cli": cli_train["k2"], "keyframe_cli": cli_train["k2_keyframe_cli"],
                          "audio_joint_cli": cli_train["k2_audio_joint_cli"],
                          "audio_separate_cli": cli_train["k2_audio_separate_cli"],
                          "av_training_cli": cli_train["k2_av_cli"]},
        "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        **bound(*quant_matmul_work(*K2_TRAIN_SHAPE, 4, 64)),
        "library_ms": None,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:301",
        "launches": train["k3"],
        "path_launches": {"lora_training": train["k3"], "training_cli": cli_train["k3"],
                          "av_lora_training": av["k3"], "av_training_cli": cli_train["k3_av_cli"]},
        "max_abs_err": k3["max_abs_err"],
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        **bound(*attention_bwd_work(s_train, 32, 128)),
        "library_ms": k3_lib_ms,
    }, {
        "name": "flash_cross_attention",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_cross_attention.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:691",
        "launches": dev["k4"],
        "path_launches": {"dev": dev["k4"], "audio_joint_dev": audio["k4"]},
        "max_abs_err": k4["max_abs_err"],
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        **bound(*cross_attention_work(2, 5184, 128, 32, 128, bias=False)),
        "library_ms": k4_lib_ms,
    }, {
        "name": "flash_attention_split_rope",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_rope.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:547",
        "launches": dev["k5"],
        "path_launches": {"dev": dev["k5"], "audio_joint_dev": audio["k5"]},
        "max_abs_err": k5["max_abs_err"],
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        **bound(*rope_attention_work(2, 5184, 32, 128)),
        "library_ms": None,
    }, {
        "name": "flash_attention_int8",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_int8.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:836",
        "launches": w8["k6"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        **bound(*int8_attention_work(1, 1280, 32, 128), peak_ops=PEAK_INT8_OPS),
        "library_ms": None,
        "prologue_ms": k6_prologue_ms,
        "prologue_launches": w8["k6_prologue"],
    }]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        fail(f"no launch on its path: {', '.join(idle)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
