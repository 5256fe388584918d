from .center_target import draw_gaussian, gaussian_2d, gaussian_radius

__all__ = ["draw_gaussian", "gaussian_2d", "gaussian_radius"]
