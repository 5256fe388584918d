from .bev_feature import (BEVFeature, BEVFeatureExtractor, BEVStrideFeature,
                          bev_cells, roi_grid_points)

__all__ = ["BEVFeature", "BEVFeatureExtractor", "BEVStrideFeature",
           "bev_cells", "roi_grid_points"]
