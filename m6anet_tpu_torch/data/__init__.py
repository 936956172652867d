from .batching import SiteBatch, pack_sites  # noqa: F401
from .dataset import ConcatSiteDataset, ReplicateSiteDataset, Site, SiteDataset, build_dataset  # noqa: F401
from .norm import compute_norm_dict, load_norm_factors  # noqa: F401
