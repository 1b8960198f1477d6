"""The legacy dev-pipeline entry (counterpart of mlx_video_tpu/generate_dev.py):
``generate_video_dev`` and ``python -m mlx_video_tpu_torch.generate_dev``,
which is the generate CLI with ``--pipeline dev`` ahead of the given flags.
(The JAX entry calls ``main(["--pipeline", "dev"])`` and so drops every flag
given on its command line; the port passes them on.)"""

import sys

from mlx_video_tpu_torch.generate import (  # noqa: F401
    AUDIO_LATENTS_PER_SECOND,
    AUDIO_SAMPLE_RATE,
    DEFAULT_NEGATIVE_PROMPT,
    cfg_delta,
    compute_audio_frames,
    create_audio_position_grid,
    create_position_grid,
    generate_video,
    ltx2_scheduler,
    main,
)


def generate_video_dev(*args, tiling: str = "none", **kwargs):
    """Dev single-stage CFG generation (the reference's name)."""
    from mlx_video_tpu_torch.pipelines.generate import PipelineType

    kwargs.setdefault("pipeline", PipelineType.DEV)
    return generate_video(*args, tiling=tiling, **kwargs)


def legacy_main(argv=None) -> None:
    """The generate CLI with ``--pipeline dev`` first; a later
    ``--pipeline`` in ``argv`` (default: the command line) wins."""
    main(["--pipeline", "dev", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    legacy_main()
