from .metric import Metric
from .averagemeter import AverageValueListMeter, AverageValueMeter, MultipleAverageValueMeter
from .meter_interface import MeterInterface
from .display import meter_display
from .dice import UniversalDice, dice_stats_from_labels
from .surface import SurfaceMeter, average_surface_distance, hausdorff_distance
from .storage import Storage

__all__ = ["Metric", "AverageValueMeter", "AverageValueListMeter",
           "MultipleAverageValueMeter", "MeterInterface", "meter_display",
           "UniversalDice", "dice_stats_from_labels", "SurfaceMeter", "hausdorff_distance",
           "average_surface_distance", "Storage"]
