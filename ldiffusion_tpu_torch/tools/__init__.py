"""Command-line tools over the SD components: ``sample`` (a decode at every
reverse step) and ``pixel_latent_vector`` (per-pixel trajectory features to
CSV)."""
