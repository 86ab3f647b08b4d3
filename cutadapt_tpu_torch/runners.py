"""
Pipeline runners.

Serial mode first offers the run to the batched device engine
(accel.try_run_accelerated) and only falls back to the per-read loop
for ineligible configurations. Parallel mode is host data parallelism
over record-aligned chunks: one reader process feeds whichever worker
asks next (dynamic balancing), workers stream their output buffers
back, and the main process writes them strictly in chunk-index order —
output is byte-identical for any worker count.

Wire protocol (per connection): a non-negative int is a chunk index;
CHUNK_DONE ends a stream (workers follow it with their Statistics);
CHUNK_FAILED is followed by (exception, formatted traceback) and
terminates the run on the receiving side.

Reference parity: runners.py:38-473 of cutadapt:src/cutadapt.
"""

import io
import logging
import multiprocessing
import os
import sys
import traceback
from abc import ABC, abstractmethod
from contextlib import ExitStack
from itertools import count
from multiprocessing.connection import Connection
from types import SimpleNamespace
from typing import Iterator, List, Optional, Tuple

from .io.fastq import read_chunks, read_paired_chunks
from .io.files import (
    FileFormat,
    InputFiles,
    InputPaths,
    OutputFiles,
    detect_file_format,
    xopen_rb_raise_limit,
)
from .pipeline import Pipeline
from .report import Statistics
from .utils import Progress

logger = logging.getLogger()

mpctx = multiprocessing.get_context()

CHUNK_DONE = -1
CHUNK_FAILED = -2


def send_failure(connection: Connection, exc: BaseException) -> None:
    """Ship an exception over a connection (tracebacks cannot be
    pickled, so the formatted text travels alongside)."""
    connection.send(CHUNK_FAILED)
    connection.send((exc, traceback.format_exc()))


def receive_checked(connection: Connection):
    """Receive one control value; re-raise a shipped failure after
    terminating all children."""
    value = connection.recv()
    if value != CHUNK_FAILED:
        return value
    exc, tb_text = connection.recv()
    logger.debug("%s", tb_text)
    for child in multiprocessing.active_children():
        child.terminate()
    raise exc


def _pipes(n: int):
    """n one-way pipes as (receive_ends, send_ends) tuples."""
    made = [mpctx.Pipe(duplex=False) for _ in range(n)]
    return tuple(p[0] for p in made), tuple(p[1] for p in made)


class ReaderProcess(mpctx.Process):
    """
    Reads record-aligned chunks (single or paired) and sends each to
    whichever worker requests work next. Detects the input file format
    first and ships it back over a dedicated pipe (inputs may be
    non-seekable pipes, so only this process can look at the bytes).

    All construction parameters travel to the child as one pickled
    namespace (`self._c`).
    """

    def __init__(self, *paths: str, file_format_connection, connections,
                 queue, buffer_size: int, stdin_fd):
        super().__init__()
        if not 1 <= len(paths) <= 2:
            raise ValueError("Reading requires one or two input files")
        self._c = SimpleNamespace(
            paths=paths,
            format_conn=file_format_connection,
            worker_conns=tuple(connections),
            queue=queue,
            buffer_size=buffer_size,
            stdin_fd=stdin_fd,
        )

    # the parallel runner reads these back for orchestration/tests
    @property
    def connections(self):
        return self._c.worker_conns

    @property
    def queue(self):
        return self._c.queue

    def _next_requester(self) -> Connection:
        return self._c.worker_conns[self._c.queue.get()]

    def _reattach_stdin(self) -> None:
        if self._c.stdin_fd != -1:
            # stdin was replaced by the parent; reattach it
            sys.stdin.close()
            sys.stdin = os.fdopen(self._c.stdin_fd)

    def run(self):
        self._reattach_stdin()
        try:
            with ExitStack() as stack:
                try:
                    opened = [
                        stack.enter_context(xopen_rb_raise_limit(p))
                        for p in self._c.paths
                    ]
                    # the shard contract must hold on the
                    # multiprocessing path too: this process re-opens
                    # the raw paths, so re-apply the byte-range view
                    from .parallel.multihost import maybe_range_readers

                    opened = maybe_range_readers(
                        opened,
                        os.environ.get("CUTADAPT_TPU_TORCH_BYTE_RANGE"),
                    )
                    detected = detect_file_format(opened[0])
                except Exception as e:
                    send_failure(self._c.format_conn, e)
                    raise
                self._c.format_conn.send(detected)
                self._serve(opened)
            # orderly end: one poison pill per worker
            for _ in self._c.worker_conns:
                self._next_requester().send(CHUNK_DONE)
        except Exception as e:
            for conn in self._c.worker_conns:
                send_failure(conn, e)

    def _serve(self, opened) -> None:
        for index, parts in enumerate(self._chunk_stream(opened)):
            conn = self._next_requester()
            conn.send(index)
            for part in parts:
                conn.send_bytes(part)

    def _chunk_stream(self, opened) -> Iterator[Tuple[memoryview, ...]]:
        size = self._c.buffer_size
        if len(opened) == 2:
            yield from read_paired_chunks(opened[0], opened[1], size)
        else:
            yield from ((c,) for c in read_chunks(opened[0], size))


class WorkerProcess(mpctx.Process):
    """
    Requests chunks, runs its own copy of the pipeline over each, and
    streams the proxied output buffers back tagged with the chunk
    index; finishes with CHUNK_DONE plus its accumulated Statistics.
    """

    def __init__(self, id_: int, pipeline: Pipeline, inpaths: InputPaths,
                 proxy_files, read_pipe, write_pipe, need_work_queue,
                 file_format):
        super().__init__()
        self._c = SimpleNamespace(
            id=id_,
            pipeline=pipeline,
            n_inputs=len(inpaths.paths),
            interleaved=inpaths.interleaved,
            read_pipe=read_pipe,
            write_pipe=write_pipe,
            queue=need_work_queue,
            proxies=proxy_files,
            file_format=file_format,
        )

    def _incoming(self) -> Iterator[int]:
        """Chunk indexes as the reader grants them; ends at the poison
        pill, re-raises a shipped reader failure."""
        c = self._c
        while True:
            c.queue.put(c.id)
            got = c.read_pipe.recv()
            if got == CHUNK_DONE:
                return
            if got == CHUNK_FAILED:
                exc, tb_text = c.read_pipe.recv()
                logger.error("%s", tb_text)
                raise exc
            yield got

    def run(self):
        c = self._c
        try:
            stats = Statistics()
            for chunk_index in self._incoming():
                stats += self._process_chunk(chunk_index)
            # counters living in the pipeline objects are collected once
            stats += Statistics().collect(
                0,
                0,
                0 if c.pipeline.paired else None,
                c.pipeline._modifiers,
                c.pipeline._steps,
            )
            c.write_pipe.send(CHUNK_DONE)
            c.write_pipe.send(stats)
        except Exception as e:
            send_failure(c.write_pipe, e)

    def _process_chunk(self, chunk_index: int) -> Statistics:
        """Run the pipeline over one received chunk and ship the
        resulting output bytes."""
        c = self._c
        payloads = [c.read_pipe.recv_bytes() for _ in range(c.n_inputs)]
        infiles = InputFiles(
            *map(io.BytesIO, payloads),
            interleaved=c.interleaved,
            fileformat=c.file_format,
        )
        (n, bp1, bp2) = c.pipeline.process_reads(infiles)
        c.write_pipe.send(chunk_index)
        c.write_pipe.send(n)
        for proxy in c.proxies:
            for blob in proxy.drain():
                c.write_pipe.send_bytes(blob)
        return Statistics().collect(n, bp1, bp2, [], [])


class OrderedChunkWriter:
    """
    Accept chunks in any order, write them strictly by chunk index
    (deterministic output independent of scheduling).
    """

    def __init__(self, outfile):
        self._pending = {}
        self._order = count()
        self._due = next(self._order)
        self._outfile = outfile

    def write(self, data: bytes, index: int):
        self._pending[index] = data
        while self._due in self._pending:
            self._outfile.write(self._pending.pop(self._due))
            self._due = next(self._order)

    def wrote_everything(self):
        return not self._pending


class PipelineRunner(ABC):
    """A read-processing pipeline runner."""

    @abstractmethod
    def run(self, pipeline, progress: Progress, outfiles: OutputFiles) -> Statistics:
        pass

    @abstractmethod
    def close(self):
        pass

    @abstractmethod
    def input_file_format(self) -> FileFormat:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def _parent_stdin_fd() -> int:
    try:
        return sys.stdin.fileno()
    except io.UnsupportedOperation:
        # stdin replaced by an object without a file descriptor
        return -1


class ParallelPipelineRunner(PipelineRunner):
    """
    Reader process -> n worker processes -> in-order main-process
    writer. The whole pipeline object graph is pickled into each
    worker; outputs must be proxied.
    """

    def __init__(
        self,
        inpaths: InputPaths,
        n_workers: int,
        buffer_size: Optional[int] = None,
    ):
        self._n_workers = n_workers
        self._inpaths = inpaths
        self._buffer_size = 4 * 1024**2 if buffer_size is None else buffer_size
        self._need_work_queue: multiprocessing.Queue = mpctx.Queue()
        # pipes the workers receive their chunks on
        self._connections, reader_side = _pipes(n_workers)
        self._input_file_format = self._start_reader(reader_side)
        bam = self._input_file_format is FileFormat.BAM
        # individual BAM record chunks carry no header
        self._format_string = (
            "bam_no_header" if bam else self._input_file_format.name.lower()
        )

    def _start_reader(self, worker_sides) -> FileFormat:
        format_recv, format_send = mpctx.Pipe(duplex=False)
        reader = ReaderProcess(
            *self._inpaths.paths,
            file_format_connection=format_send,
            connections=worker_sides,
            queue=self._need_work_queue,
            buffer_size=self._buffer_size,
            stdin_fd=_parent_stdin_fd(),
        )
        reader.daemon = True
        reader.start()
        self._reader_process = reader
        return receive_checked(format_recv)

    def _launch_workers(self, pipeline, proxy_files):
        result_recv, result_send = _pipes(self._n_workers)
        workers = []
        for index in range(self._n_workers):
            worker = WorkerProcess(
                index,
                pipeline,
                self._inpaths,
                proxy_files,
                self._connections[index],
                result_send[index],
                self._need_work_queue,
                file_format=self._format_string,
            )
            worker.daemon = True
            worker.start()
            workers.append(worker)
        return workers, list(result_recv)

    def run(self, pipeline, progress, outfiles: OutputFiles) -> Statistics:
        workers, connections = self._launch_workers(
            pipeline, outfiles.proxy_files()
        )
        writers = [OrderedChunkWriter(f) for f in outfiles.binary_files()]
        stats = Statistics()
        while connections:
            for connection in multiprocessing.connection.wait(connections):
                chunk_index = receive_checked(connection)
                if chunk_index == CHUNK_DONE:
                    stats += receive_checked(connection)
                    connections.remove(connection)
                    continue
                progress.update(receive_checked(connection))
                for writer in writers:
                    writer.write(connection.recv_bytes(), chunk_index)
        assert all(writer.wrote_everything() for writer in writers)
        for proc in workers + [self._reader_process]:
            proc.join()
        progress.close()
        return stats

    def close(self) -> None:
        pass

    def input_file_format(self) -> FileFormat:
        return self._input_file_format


class SerialPipelineRunner(PipelineRunner):
    """Run a pipeline in-process (device engine when eligible)."""

    def __init__(self, infiles: InputFiles):
        self._infiles = infiles

    def run(
        self, pipeline: Pipeline, progress: Progress, outfiles: OutputFiles
    ) -> Statistics:
        from .accel import try_run_accelerated

        stats = try_run_accelerated(pipeline, self._infiles, progress)
        if stats is not None:
            return stats
        (n, bp1, bp2) = pipeline.process_reads(self._infiles, progress=progress)
        if progress is not None:
            progress.close()
        return Statistics().collect(
            n, bp1, bp2, pipeline._modifiers, pipeline._steps
        )

    def close(self):
        self._infiles.close()

    def input_file_format(self) -> FileFormat:
        return detect_file_format(self._infiles._files[0])


def make_runner(
    inpaths: InputPaths,
    cores: int,
    buffer_size: Optional[int] = None,
) -> PipelineRunner:
    """
    Return a SerialPipelineRunner if cores == 1, else a
    ParallelPipelineRunner with `cores` worker processes.
    """
    if cores > 1:
        return ParallelPipelineRunner(
            inpaths, n_workers=cores, buffer_size=buffer_size
        )
    return SerialPipelineRunner(inpaths.open())
