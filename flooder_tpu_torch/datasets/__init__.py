from .datasets import (
    BaseDataset,
    CoralDataset,
    FlooderData,
    FlooderDataset,
    FlooderRocksData,
    LargePointCloudData,
    LargePointCloudDataset,
    MCBDataset,
    ModelNet10Dataset,
    RocksDataset,
    SwisscheeseDataset,
)

__all__ = [
    "BaseDataset",
    "FlooderDataset",
    "FlooderData",
    "FlooderRocksData",
    "LargePointCloudData",
    "CoralDataset",
    "MCBDataset",
    "ModelNet10Dataset",
    "RocksDataset",
    "SwisscheeseDataset",
    "LargePointCloudDataset",
]
