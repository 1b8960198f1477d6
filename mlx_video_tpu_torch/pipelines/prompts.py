"""Default prompts for the dev CFG pipeline.

The port's copy of mlx_video_tpu/pipelines/prompts.py (tests/
test_torch_port_copies.py holds it against the original).
"""

DEFAULT_NEGATIVE_PROMPT = (
    "blurry, soft focus, low resolution, heavy noise, grainy texture, overexposed, "
    "underexposed, washed out colors, color banding, compression artifacts, pixelation, "
    "ghosting, flickering, motion blur, jittery movement, stuttering motion, frame "
    "duplication, temporal drift, shaky camera, unintended camera movement, jump cuts, "
    "inconsistent perspective, warped geometry, distorted proportions, deformed faces, "
    "asymmetrical features, missing facial features, unnatural skin tones, extra limbs, "
    "missing limbs, malformed hands, wrong finger count, floating objects, background "
    "clutter, distracting reflections, harsh shadows, inconsistent lighting direction, "
    "flat lighting, oversaturated cinematic filters, cartoonish rendering, cheap 3D CGI "
    "look, uncanny valley, plastic-looking materials, watermark, logo, text artifacts, "
    "desynced audio, off-sync lip movement, robotic voice, distorted voice, echo, "
    "clipped audio, crackling, hiss, muted audio, wrong language, repetitive speech, "
    "awkward pauses, unnatural transitions, stylized filters, AI artifacts"
)
