"""The tile engine: Ultimate SD Upscale's tiled img2img (``engine``), the
tiled learned upscale (``model_upscale``) and their grid (``grid``), on
one device."""
