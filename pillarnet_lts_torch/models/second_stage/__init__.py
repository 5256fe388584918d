from .bev_feature import BEVStrideFeature, bev_cells, roi_grid_points

__all__ = ["BEVStrideFeature", "bev_cells", "roi_grid_points"]
