"""Interval math of upstream's weed/storage/erasure_coding/ec_locate.go.

A volume's .dat is striped row-major: large rows (k x large blocks) first,
then the tail as small rows (k x small blocks). A shard file is one column
of that grid, so a logical .dat range maps to a list of (shard id, offset
in the shard) intervals; the large -> small transition is the part that
needs care.
"""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT


@dataclass(frozen=True)
class Interval:
    block_index: int  # index into the row-major grid of blocks of one tier
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int
    #: row width in blocks: geometry-flexible volumes carry their own k
    data_shards: int = DATA_SHARDS_COUNT

    def to_shard_id_and_offset(self, large_block_size: int, small_block_size: int) -> tuple[int, int]:
        ec_file_offset = self.inner_block_offset
        row_index = self.block_index // self.data_shards
        if self.is_large_block:
            ec_file_offset += row_index * large_block_size
        else:
            ec_file_offset += (
                self.large_block_rows_count * large_block_size + row_index * small_block_size
            )
        return self.block_index % self.data_shards, ec_file_offset


def large_row_count(
    dat_size: int, large_block_length: int, data_shards: int = DATA_SHARDS_COUNT
) -> int:
    """Large rows the encoder emitted for a .dat of this size. The encode
    loop's condition is strictly-greater, so a volume of exactly one large
    row is encoded entirely as small rows."""
    if dat_size <= 0:
        return 0
    return (dat_size - 1) // (large_block_length * data_shards)


def locate_offset(
    large_block_length: int,
    small_block_length: int,
    dat_size: int,
    offset: int,
    data_shards: int = DATA_SHARDS_COUNT,
) -> tuple[int, bool, int, int]:
    """-> (block_index, is_large_block, n_large_block_rows, inner_block_offset)."""
    large_row_size = large_block_length * data_shards
    n_large_rows = large_row_count(dat_size, large_block_length, data_shards)
    if offset < n_large_rows * large_row_size:
        block_index, inner = divmod(offset, large_block_length)
        return block_index, True, n_large_rows, inner
    block_index, inner = divmod(offset - n_large_rows * large_row_size, small_block_length)
    return block_index, False, n_large_rows, inner


def locate_data(
    large_block_length: int,
    small_block_length: int,
    dat_size: int,
    offset: int,
    size: int,
    data_shards: int = DATA_SHARDS_COUNT,
) -> list[Interval]:
    """Split a logical .dat byte range into per-block intervals."""
    block_index, is_large, n_large_rows, inner = locate_offset(
        large_block_length, small_block_length, dat_size, offset, data_shards
    )
    intervals: list[Interval] = []
    while size > 0:
        block_len = large_block_length if is_large else small_block_length
        take = min(size, block_len - inner)
        intervals.append(
            Interval(
                block_index=block_index,
                inner_block_offset=inner,
                size=take,
                is_large_block=is_large,
                large_block_rows_count=n_large_rows,
                data_shards=data_shards,
            )
        )
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * data_shards:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
