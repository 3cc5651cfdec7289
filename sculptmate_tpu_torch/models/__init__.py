"""Image encoder, triplane tokenizer, backbone, upsampler and decoder."""
