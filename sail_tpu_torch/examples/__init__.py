"""The port's examples (counterparts of the repo's `examples/`), each run
as `python -m sail_tpu_torch.examples.<name>`: `render_scenes` (BASELINE
scenes to PNG), `viewer` (the progressive HTTP viewer) and
`inverse_render` (a fit of materials and lights to a target image)."""
