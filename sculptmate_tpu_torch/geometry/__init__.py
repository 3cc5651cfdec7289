"""Device marching cubes (wire format) and its host decoder."""
