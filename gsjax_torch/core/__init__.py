"""Camera, spherical-harmonics and covariance math."""
