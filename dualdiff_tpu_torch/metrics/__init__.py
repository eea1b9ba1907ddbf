"""FID and FVD: InceptionV3 and I3D features, the Frechet distance."""
